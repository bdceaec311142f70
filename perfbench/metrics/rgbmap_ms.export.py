"""Device time per frame of the RGB tonemap
(``color.maps.RGBColormap.to_rgba``), in ms."""

from perfbench import readers


def read(ctx):
    return readers.device_ms_per_frame(ctx, "rgbmap")
