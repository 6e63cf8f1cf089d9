"""Device ms a traced step of the hybrid's coherence sorts: every op whose
launch fell inside a ``mcpt.hybrid.sort`` span (the keys, the sort, the
tail drop and the gathers of the state and the ids), matched to its launch
by the profiler's correlation id.  Nothing to read where the span is not
recorded.  Moves ``spp_per_s``."""

from benchmark import spans


def read(ctx):
    sorts = [us for name, *_, us in spans.of(ctx)
             if name == "mcpt.hybrid.sort"]
    return sum(sorts) / 1e3 / ctx.steps if sorts else None
