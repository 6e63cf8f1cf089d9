"""Share of the traced window in which the card runs nothing, in %: one
minus the union of its activity intervals over the window.  Moves
``spp_per_s``."""

from benchmark.devtrace import busy_us, window


def read(ctx):
    lo, hi = window(ctx.trace)
    return 100.0 * (1.0 - busy_us(ctx.trace) / (hi - lo))
