"""K2 (``ops.splat_accum.accumulate_groups``): the least time of its kept
calls (``work.k2_call``) over their kernels' device time, in %."""

from perfbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "k2")
