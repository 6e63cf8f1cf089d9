"""Device ms a traced step in which the NCCL kernels on rank 0's card wait
for the slowest rank: their whole time a step less their own
(``collective_ms_per_step``: each kernel's shortest launch): how long
rank 0's card waits for the slowest rank at the collectives, a step.
Nothing to read where no NCCL kernel runs.  Moves ``spp_per_s``."""

from benchmark.devtrace import nccl_kernels


def read(ctx):
    runs = nccl_kernels(ctx.trace)
    us = sum(sum(d) - min(d) * len(d) for d in runs.values())
    return us / 1e3 / ctx.steps if runs else None
