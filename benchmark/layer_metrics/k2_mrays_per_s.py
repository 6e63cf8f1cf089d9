"""Segments of the traced steps on rank 0's card over the device time of
the fused bounce (kernel 2), ``fused_bounce_kernel``: the kernel's own
rate, in Mrays/s. Nothing to read where the kernel does not run. Moves
``spp_per_s``."""

from benchmark.devtrace import kernel_us


def read(ctx):
    us = kernel_us(ctx.trace, "fused_bounce_kernel")
    return ctx.card_segs / us if us > 0 else None
