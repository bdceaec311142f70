"""K3 (``ops.zsplat_accum.accumulate_max_packed``): the least time of its
kept calls (``work.k3_call``) over their kernels' device time, in %."""

from perfbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "k3")
