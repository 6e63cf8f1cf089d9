"""The program's own spans in a traced window: the ``mcpt.*`` host ranges
that ``mcpt_torch.trace.span`` records while the profiler runs, on the
clock of the device events ``devtrace`` reads.  The readers of the
engine's stages and of its host waits take them from here.

The harness hands a reader the trace it parsed (``devtrace.from_profile``:
the device events and the harness's own step spans).  The program's spans
are in the same profiler session, which the harness keeps until the run
ends, so they are read from that session.  A program that records no spans
gives none, and each reader then reads nothing.
"""

from __future__ import annotations

from benchmark import devtrace

PREFIX = "mcpt."


def from_profile(prof) -> list:
    """[(name, start, end, device µs)] of the program's spans in a finished
    ``torch.profiler.profile``, in the order they started.  Device µs is
    the device time of every op launched inside the span, which the
    profiler matches to its launch by correlation id, so an op counts
    wherever on the device timeline it ran."""
    from torch.autograd import DeviceType

    return sorted(((e.name, e.time_range.start, e.time_range.end,
                    e.device_time_total) for e in prof.events()
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith(PREFIX)), key=lambda x: x[1])


def _session(tr):
    """The finished ``torch.profiler.profile`` whose events hold ``tr``'s
    first harness span, or None."""
    import gc

    from torch.profiler import profile

    name, start, _ = min(tr.host, key=lambda x: x[1])
    for obj in gc.get_objects():
        if (issubclass(type(obj), profile)
                and getattr(obj, "profiler", None) is not None
                and any(e.name == name and e.time_range.start == start
                        for e in obj.events())):
            return obj
    return None


def of(ctx) -> list:
    """The program's spans inside the traced window of a reader's context
    (kept on it as ``ctx.program_spans``, so the readers parse once)."""
    found = getattr(ctx, "program_spans", None)
    if found is None:
        prof = _session(ctx.trace)
        lo, hi = devtrace.window(ctx.trace)
        found = [x for x in (from_profile(prof) if prof is not None else [])
                 if lo <= x[1] and x[2] <= hi]
        ctx.program_spans = found
    return found


def idle_gaps(tr, program) -> list:
    """[(label, µs)] of the device's idle gaps in the window, each labelled
    with the innermost span open at its middle: the program's (``program``,
    from ``of``), else the harness's, else ``between steps``."""
    lo, hi = devtrace.window(tr)
    busy = devtrace.union((max(s, lo), min(e, hi)) for _, s, e in tr.device
                          if e > lo and s < hi)
    edges = [lo] + [x for b in busy for x in b] + [hi]
    host = sorted(tr.host, key=lambda x: x[1])
    out = []
    for gs, ge in zip(edges[::2], edges[1::2]):
        if ge <= gs:
            continue
        mid = 0.5 * (gs + ge)
        inner = [n for n, s, e, _ in program if s <= mid <= e]
        label = inner[-1] if inner else next(
            (n for n, s, e in host if s <= mid <= e), "between steps")
        out.append((label, ge - gs))
    return out
