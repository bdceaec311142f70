"""Movie and image export: the window's time over the EXPORT frames it
completed, each frame ending as the presented RGBA is in host memory."""

from perfbench import readers


def read(ctx):
    if ctx["draw"] != "export":
        return None
    return readers.window_ms_per_frame(ctx)
