"""Draws per view until the progression needs no refinement, averaged
over the window's views."""

from perfbench import readers


def read(ctx):
    if ctx["draw"] != "view" or not ctx["steps"]:
        return None
    return readers.frames(ctx) / ctx["steps"]
