"""Reading a ``torch.profiler`` trace of the window's first steps: the
device's activity intervals, the benchmark's own host spans, and what the
per-layer readers and the ``breakdown`` take from them.

All times are the profiler's microseconds, on one clock for host and
device events.  The harness records its spans (``step.render``,
``step.accumulate``, ``step.readback``) as ``record_function`` ranges
around its calls into the program.
"""

from __future__ import annotations

from types import SimpleNamespace

STEP_SPANS = ("step.render", "step.accumulate", "step.readback")


def from_profile(prof) -> SimpleNamespace:
    """→ (device events [(name, start, end)], host spans [(name, start,
    end)]) of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if e.name not in STEP_SPANS:  # a range's device-side echo
                device.append(span)
        elif e.name in STEP_SPANS:
            host.append(span)
    return SimpleNamespace(device=device, host=host)


def union(intervals):
    """Sorted, merged [(start, end)] of ``intervals``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def window(tr) -> tuple:
    """The traced steps' host extent: the first span's start to the last
    span's end."""
    return (min(s for _, s, _ in tr.host), max(e for _, _, e in tr.host))


def busy_us(tr) -> float:
    """µs of the traced window in which the device ran anything (the union
    of its kernel, copy and set intervals)."""
    lo, hi = window(tr)
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in union((s, e) for _, s, e in tr.device))


def idle_gaps(tr) -> list:
    """[(label, µs)] of the device's idle gaps in the window, each labelled
    with the host span open at its middle (``between steps`` if none)."""
    lo, hi = window(tr)
    busy = union((max(s, lo), min(e, hi)) for _, s, e in tr.device
                 if e > lo and s < hi)
    edges = [lo] + [x for b in busy for x in b] + [hi]
    spans = sorted(tr.host, key=lambda x: x[1])
    out = []
    for gs, ge in zip(edges[::2], edges[1::2]):
        if ge <= gs:
            continue
        mid = 0.5 * (gs + ge)
        label = next((n for n, s, e in spans if s <= mid <= e),
                     "between steps")
        out.append((label, ge - gs))
    return out


def by_name(tr) -> dict:
    """{device op name: total µs}."""
    out: dict = {}
    for name, s, e in tr.device:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def kernel_us(tr, kernel: str) -> float:
    """Device µs of every launch of the program's CUDA kernel ``kernel``
    (matched in the demangled or the mangled name)."""
    return sum(e - s for name, s, e in tr.device if kernel in name)


def is_program_kernel(name: str) -> bool:
    """A kernel of the program's own CUDA sources (namespace ``mcpt``)."""
    return "mcpt::" in name or name.startswith("_ZN4mcpt")
