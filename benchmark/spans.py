"""The program's own spans in a traced window: the ``mcpt.*`` host ranges
that ``mcpt_torch.trace.span`` records while the profiler runs, on the
clock of the device events (``devtrace.from_profile`` reads them with the
rest of the trace).  The readers of the engine's stages and of its host
waits take them from here.  A program that records no spans gives none,
and each reader then reads nothing.
"""

from __future__ import annotations

from benchmark import devtrace

PREFIX = devtrace.PROGRAM_PREFIX


def of(ctx) -> list:
    """The program's spans inside the traced window of a reader's context,
    [(name, start, end, device µs)] (kept on it as ``ctx.program_spans``,
    so the readers filter once)."""
    found = getattr(ctx, "program_spans", None)
    if found is None:
        found = ctx.program_spans = devtrace.program_spans(ctx.trace)
    return found
