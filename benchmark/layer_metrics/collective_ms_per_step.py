"""The collectives' own device ms a traced step on rank 0's card: for each
NCCL kernel (the mesh's all-reduce of the rows, and of the segment count),
its shortest launch over the traced steps times its launches a step.  A
kernel runs from its launch until every rank has joined, so each launch
holds the wait for the slowest rank; the shortest is the step where rank
0 came last and the kernel moved its bytes alone.  The wait is
``lockstep_wait_ms_per_step``'s.  Nothing to read where no NCCL kernel
runs.  Moves ``spp_per_s``."""

from benchmark.devtrace import nccl_kernels


def read(ctx):
    runs = nccl_kernels(ctx.trace)
    us = sum(min(d) * len(d) for d in runs.values())
    return us / 1e3 / ctx.steps if runs else None
