"""Host time per frame inside ``Visualizer.render_sph`` (the renderer
and progression enqueueing the frame's launches), in ms."""

from perfbench import readers


def read(ctx):
    return readers.host_ms_per_frame(ctx, "enqueue")
