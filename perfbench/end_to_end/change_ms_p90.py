"""The first image after a drag: the 90th percentile over all views of the
time from the view change to the CHANGE frame in host memory, in ms."""

from perfbench import readers


def read(ctx):
    return readers.view_tail_ms(ctx, 90.0, first_frame=True)
