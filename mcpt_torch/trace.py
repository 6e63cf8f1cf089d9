"""Spans of the port's host code, on the clock of the profiler's trace.

``span(name)`` marks a stage of an engine, or a wait of the host on the
card.  It records only while a ``torch.profiler`` session is recording:
then it is a host range in that session's trace, on the clock the trace
gives the card's kernels and copies, so a gap in the card's activity can be
put down to the span open on the host at that moment, and the device time
of every op launched inside it adds up under it (the profiler matches each
op to its launch by correlation id).  Otherwise it is one boolean check and
a shared no-op context; it never synchronises.

The range is PyTorch's fast record function (``RecordScope.FUNCTION``, as
the ops' own ranges), not ``torch.profiler.record_function``: a user-scope
range also leaves an echo of itself on the device timeline, from the first
to the last op launched inside it, which a reader of the trace would count
as device work.

Every name starts with ``mcpt.``.  ``mcpt.wait.<site>`` marks a read that
blocks the host until the card has caught up, so the number of those spans
in a trace is the number of host waits, by site.  ``count(name, n)`` leaves
a value in the trace the same way: an empty range named
``mcpt.count.<name>=<n>``, with no sync and no read of the card.
``report`` is what ``render_cli --profile`` prints.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()
COUNT_PREFIX = "mcpt.count."
_recording = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context that is a profiler range named ``name`` while a profiler
    records, else the shared no-op context."""
    if not _recording():
        return _OFF
    return _range(name)


def count(name: str, n: int) -> None:
    """While a profiler records, an empty range ``mcpt.count.<name>=<n>``:
    the value ``n`` of counter ``name`` at this point of the host's run;
    else nothing."""
    if _recording():
        with _range(f"{COUNT_PREFIX}{name}={int(n)}"):
            pass


def counted(span_name: str):
    """``(counter, value)`` of a range ``count`` left, else None."""
    if not span_name.startswith(COUNT_PREFIX):
        return None
    counter, _, value = span_name.partition("=")
    return counter, int(value)


def spanned(name: str):
    """Decorator: every call of the function is ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def report(prof, steps: int) -> str:
    """The ``mcpt.`` spans of a finished ``torch.profiler.profile`` over
    ``steps`` steps: a row a name with its calls, host ms and device ms
    (every op launched inside) a step, and, where the trace holds the card's
    activity, the ms a step the card idled while the span was the innermost
    one open (at the idle gap's middle), and the card's busy share of the
    trace's host extent."""
    from torch.autograd import DeviceType

    host, device, spans, counters = [], [], [], {}
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            host.append((s, t))
            if c := counted(e.name):
                row = counters.setdefault(c[0], [0, 0])
                row[0] += 1
                row[1] += c[1]
            elif e.name.startswith("mcpt."):
                spans.append((s, t, e.name, e.device_time_total))
        elif not e.is_user_annotation:
            device.append((s, t))
    rows: dict = {}
    for s, t, name, dev_us in spans:
        row = rows.setdefault(name, [0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += t - s
        row[2] += dev_us
    lo, hi = min(s for s, _ in host), max(t for _, t in host)
    busy = _union((max(s, lo), min(t, hi)) for s, t in device
                  if t > lo and s < hi)
    lines = [f"profile: {steps} steps under torch.profiler, {len(spans)} "
             f"mcpt spans"]
    if busy:
        edges = [lo] + [x for b in busy for x in b] + [hi]
        by_start = sorted(spans)
        outside = 0.0
        for gs, ge in zip(edges[::2], edges[1::2]):
            mid = 0.5 * (gs + ge)
            inner = [name for s, t, name, _ in by_start if s <= mid <= t]
            if inner:
                rows[inner[-1]][3] += ge - gs
            else:
                outside += max(0.0, ge - gs)
        busy_us = sum(e - s for s, e in busy)
        lines.append(f"card busy {busy_us / (hi - lo):.1%} of "
                     f"{(hi - lo) / 1e3:.3f} ms; idle outside mcpt spans "
                     f"{outside / 1e3 / steps:.3f} ms a step")
    width = max((len(n) for n in [*rows, *counters]), default=4)
    lines.append(f"{'span':<{width}}  calls/step  host ms/step  "
                 f"device ms/step" + ("  idle ms/step" if busy else ""))
    for name, (n, h, d, idle) in sorted(rows.items(),
                                        key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<{width}}  {n / steps:10.2f}  "
                     f"{h / 1e3 / steps:12.3f}  {d / 1e3 / steps:14.3f}"
                     + (f"  {idle / 1e3 / steps:12.3f}" if busy else ""))
    for name, (n, total) in sorted(counters.items()):
        lines.append(f"{name:<{width}}  {n / steps:10.2f}  value/step "
                     f"{total / steps:.1f}")
    return "\n".join(lines)
