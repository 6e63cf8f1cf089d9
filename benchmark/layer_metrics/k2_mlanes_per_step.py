"""Lanes the fused bounce (kernel 2) is launched over a traced step, in
millions: the values of the program's ``mcpt.count.k2_lanes=<n>`` counter
(one a bounce, the pool's rows × 128), summed over the traced steps.  It is
the work the pilot's compaction caps leave kernel 2: a change to the caps,
their quantisation or the sort key moves it.  Nothing to read where the
program records no such counter.  Moves ``spp_per_s``."""

from benchmark import spans

COUNTER = spans.PREFIX + "count.k2_lanes="


def read(ctx):
    lanes = [int(name[len(COUNTER):]) for name, *_ in spans.of(ctx)
             if name.startswith(COUNTER)]
    return sum(lanes) / 1e6 / ctx.steps if lanes else None
