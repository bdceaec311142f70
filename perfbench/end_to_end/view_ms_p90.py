"""The completed view: the 90th percentile over all views of the time from
the view change to the last REFINE frame in host memory, in ms."""

from perfbench import readers


def read(ctx):
    return readers.view_tail_ms(ctx, 90.0, first_frame=False)
