"""Device-idle ms a traced step while the host runs the program's own code:
the idle gaps whose middle falls inside one of its ``mcpt.*`` spans (its
stages, launches, reductions and waits), as against the harness's calls
and the time between steps.  Nothing to read where the program records no
spans.  Moves ``spp_per_s``."""

from benchmark import devtrace, spans


def read(ctx):
    found = spans.of(ctx)
    if not found:
        return None
    us = sum(us for label, us in devtrace.idle_gaps(ctx.trace, found)
             if label.startswith(spans.PREFIX))
    return us / 1e3 / ctx.steps
