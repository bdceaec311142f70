"""The share of the traced window in which the card ran no kernel, copy or
fill, in %."""

from perfbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
