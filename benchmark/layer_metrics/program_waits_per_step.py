"""Host waits a traced step at the program's own sites: its
``mcpt.wait.*`` spans (the fused bounce's and the cluster megakernel's
overflow flags, the hybrid's camera table), the step's readback by the
harness left out.  Nothing to read where the program records no spans.
Moves ``spp_per_s``."""

from benchmark import spans


def read(ctx):
    found = spans.of(ctx)
    if not found:
        return None
    waits = sum(1 for name, *_ in found if name.startswith("mcpt.wait."))
    return waits / ctx.steps
