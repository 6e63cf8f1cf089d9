"""The readers of the program's own spans (``benchmark/spans.py``) on the
CPU: on a synthetic trace, on a real profile of the port's spans, on a
trace without them (the parent's: they read nothing, and the harness's own
labels stand), and in a traced run of a tiny cell.

    python -m pytest benchmark/tests -q
"""

import json
from types import SimpleNamespace

import pytest
import torch
from benchtools import ROOT, tiny_checkout

from benchmark import devtrace, harness, spans

BENCH = ROOT / "benchmark"


def _trace():
    # test_bench_harness's trace: two steps on a 0-100 µs host window,
    # device busy 10-30, 25-40, 70-90, 92-94, 96-97
    host = [("step.render", 0, 45), ("step.accumulate", 45, 50),
            ("step.readback", 50, 55), ("step.render", 55, 95),
            ("step.accumulate", 95, 97), ("step.readback", 97, 100)]
    device = [("void mcpt::render_mega_kernel<false, 0>(mcpt::Params)", 10,
               30), ("Memcpy DtoH (Device -> Pinned)", 25, 40),
              ("_ZN4mcpt19fused_bounce_kernelEv", 70, 90),
              ("void at::native::reduce_kernel<512>", 92, 94),
              ("Memcpy DtoH (Device -> Pinned)", 96, 97)]
    return SimpleNamespace(host=host, device=device)


# the program's spans of those steps: (name, start, end, device µs); the
# second sort's ops (launched 60-68) run at 70-90, after it has closed
PROGRAM = [("mcpt.hybrid.raygen", 1, 8, 0.0),
           ("mcpt.hybrid.bounce", 9, 42, 35.0),
           ("mcpt.wait.k2_flag", 31, 41, 15.0),
           ("mcpt.hybrid.sort", 42, 44, 0.0),
           ("mcpt.accumulate", 46, 49, 0.0),
           ("mcpt.hybrid.bounce", 56, 89, 0.0),
           ("mcpt.hybrid.sort", 60, 68, 20.0),
           ("mcpt.wait.k2_flag", 69, 89, 0.0),
           ("mcpt.hybrid.reduce", 90, 94, 2.0)]


def _read(name, program=PROGRAM):
    ctx = SimpleNamespace(trace=_trace(), steps=2, segs=1e6, card_segs=1e6,
                          spans={},
                          program_spans=program)
    return harness._module(BENCH / "layer_metrics" / f"{name}.py").read(ctx)


def test_bench_idle_gaps_take_the_innermost_span():
    gaps = devtrace.idle_gaps(_trace(), PROGRAM)
    assert sum(us for _, us in gaps) == 100 - 53
    # 0-10 falls in the raygen, 40-70 in the first readback (its middle,
    # 55, is before the second bounce), 90-92 in the reduce, 94-96 and
    # 97-100 in the harness's spans
    assert gaps == [("mcpt.hybrid.raygen", 10), ("step.readback", 30),
                    ("mcpt.hybrid.reduce", 2), ("step.render", 2),
                    ("step.readback", 3)]


def test_bench_without_program_spans_the_harness_labels_stand():
    assert devtrace.idle_gaps(_trace(), []) == devtrace.idle_gaps(_trace())
    for name in ("program_waits_per_step", "engine_idle_ms_per_step",
                 "hybrid_sort_ms_per_step"):
        assert _read(name, program=[]) is None, name


def test_bench_span_readers():
    assert _read("program_waits_per_step") == 1.0
    # idle under mcpt spans: the raygen's 10 µs and the reduce's 2
    assert _read("engine_idle_ms_per_step") == pytest.approx(12 / 1e3 / 2)
    # by launch: the second sort's 20 µs ran after it closed
    assert _read("hybrid_sort_ms_per_step") == pytest.approx(20 / 1e3 / 2)
    no_sort = [x for x in PROGRAM if x[0] != "mcpt.hybrid.sort"]
    assert _read("hybrid_sort_ms_per_step", program=no_sort) is None


def test_bench_spans_from_a_profile_of_the_port():
    """The port's spans in a CPU profile: names, nesting order and each
    span's device time (none on the CPU), read with the rest of the
    harness's trace of it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mcpt_torch.trace import span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("step.render"):
            with span("mcpt.hybrid.bounce"):
                with span("mcpt.wait.k2_flag"):
                    torch.ones(4).sum()
        with record_function("step.readback"):
            pass
    found = devtrace.from_profile(prof).program
    assert [x[0] for x in found] == ["mcpt.hybrid.bounce",
                                     "mcpt.wait.k2_flag"]
    assert found[0][1] <= found[1][1] <= found[1][2] <= found[0][2]
    assert all(x[3] == 0.0 for x in found)
    ctx = SimpleNamespace(trace=devtrace.from_profile(prof), steps=1)
    assert spans.of(ctx) == found and ctx.program_spans == found


def test_bench_traced_run_reads_the_program_spans(tmp_path):
    """A traced run of a tiny cell through the harness: the readers find
    the session's spans (the accumulate's; the plain megakernel on the CPU
    records none of its own)."""
    root = tiny_checkout(tmp_path, engine="mega", spp=2)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in ("program_waits_per_step", "engine_idle_ms_per_step",
                         "hybrid_sort_ms_per_step"):
            m["workloads"] = ["tiny-mega"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("tiny-mega", root)
    result, lines = harness.run_cell(cell, 2**33 + 7, 0.2, True,
                                     torch.device("cpu"), 0.0)
    assert result["correct"], lines
    metrics = result["metrics"]
    assert metrics["program_waits_per_step"]["value"] == 0.0
    assert metrics["engine_idle_ms_per_step"]["value"] >= 0.0
    assert "hybrid_sort_ms_per_step" not in metrics
