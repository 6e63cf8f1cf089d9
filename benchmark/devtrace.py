"""Reading a ``torch.profiler`` trace of the window's first steps: the
device's activity intervals, the benchmark's own host spans, the
program's spans, and what the per-layer readers and the ``breakdown``
take from them.

All times are the profiler's microseconds, on one clock for host and
device events.  The harness records its spans (``step.render``,
``step.accumulate``, ``step.readback``, and on several ranks
``step.agree``) as ``record_function`` ranges around its calls into the
program; the program records its own ``mcpt.*`` ranges
(``mcpt_torch.trace.span``) while the profiler runs.
"""

from __future__ import annotations

from types import SimpleNamespace

STEP_SPANS = ("step.render", "step.accumulate", "step.readback",
              "step.agree")
PROGRAM_PREFIX = "mcpt."


def from_profile(prof) -> SimpleNamespace:
    """→ (device events [(name, start, end)], host spans [(name, start,
    end)], program spans [(name, start, end, device µs)] in the order they
    started) of a finished ``torch.profiler.profile``.  A program span's
    device µs is the device time of every op launched inside it, which the
    profiler matches to its launch by correlation id, so an op counts
    wherever on the device timeline it ran."""
    from torch.autograd import DeviceType

    device, host, program = [], [], []
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # a range's device-side echo (the harness's, or one a library
            # records, such as c10d's ``nccl:all_reduce`` around its kernel)
            if not (e.name in STEP_SPANS
                    or getattr(e, "is_user_annotation", False)):
                device.append(span)
        elif e.name in STEP_SPANS:
            host.append(span)
        elif (e.device_type == DeviceType.CPU
              and e.name.startswith(PROGRAM_PREFIX)):
            program.append((*span, e.device_time_total))
    program.sort(key=lambda x: x[1])
    return SimpleNamespace(device=device, host=host, program=program)


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


def program_spans(tr) -> list:
    """The program's spans inside the traced window (none in a trace that
    holds none)."""
    lo, hi = window(tr)
    return [x for x in getattr(tr, "program", ())
            if lo <= x[1] and x[2] <= hi]


def idle_gaps(tr, program=None) -> list:
    """[(label, µs)] of the device's idle gaps in the window, each labelled
    with the innermost span open at its middle: the program's (``program``,
    by default ``program_spans(tr)``), else the harness's, else ``between
    steps``."""
    lo, hi = window(tr)
    busy = union((max(s, lo), min(e, hi)) for _, s, e in tr.device
                 if e > lo and s < hi)
    edges = [lo] + [x for b in busy for x in b] + [hi]
    host = sorted(tr.host, key=lambda x: x[1])
    if program is None:
        program = program_spans(tr)
    out = []
    for gs, ge in zip(edges[::2], edges[1::2]):
        if ge <= gs:
            continue
        mid = 0.5 * (gs + ge)
        inner = [x[0] for x in program if x[1] <= mid <= x[2]]
        label = inner[-1] if inner else next(
            (n for n, s, e in host if s <= mid <= e), "between steps")
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


def is_nccl_kernel(name: str) -> bool:
    """A kernel of NCCL (``ncclDevKernel_*``, ``ncclKernel_*``)."""
    return name.startswith(("ncclDevKernel", "ncclKernel"))


def nccl_kernels(tr) -> dict:
    """{NCCL kernel name: [µs of each launch]}."""
    out: dict = {}
    for name, s, e in tr.device:
        if is_nccl_kernel(name):
            out.setdefault(name, []).append(e - s)
    return out


def is_program_kernel(name: str) -> bool:
    """A kernel of the program's own CUDA sources (namespace ``mcpt``)."""
    return "mcpt::" in name or name.startswith("_ZN4mcpt")
