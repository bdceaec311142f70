"""Device time per frame of the bilateral filter
(``ops.smooth.smooth_image`` as the surface colormap calls it), in ms."""

from perfbench import readers


def read(ctx):
    return readers.device_ms_per_frame(ctx, "filter")
