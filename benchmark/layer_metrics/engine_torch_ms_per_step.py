"""Device ms a traced step of every operation that is not one of the
program's CUDA kernels: the engines' torch stages (sorts, gathers, camera
rays, roulette, reductions), the accumulate and the copies.  NCCL's
kernels are the collectives' (``collective_ms_per_step``).  Moves
``spp_per_s``."""

from benchmark.devtrace import is_nccl_kernel, is_program_kernel


def read(ctx):
    us = sum(e - s for name, s, e in ctx.trace.device
             if not (is_program_kernel(name) or is_nccl_kernel(name)))
    return us / 1e3 / ctx.steps
