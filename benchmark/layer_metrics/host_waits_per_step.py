"""Device-to-host copies a traced step: each one is a wait of the host on
the card (the step's segment readback, and the program's own flag reads).
Moves ``spp_per_s``."""


def read(ctx):
    n = sum(1 for name, _, _ in ctx.trace.device if "DtoH" in name)
    return n / ctx.steps
