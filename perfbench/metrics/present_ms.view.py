"""Host time per frame inside ``Visualizer._compose_presentation``
(colormap, fit, readback and the host's uint8 passes), in ms."""

from perfbench import readers


def read(ctx):
    return readers.host_ms_per_frame(ctx, "present")
