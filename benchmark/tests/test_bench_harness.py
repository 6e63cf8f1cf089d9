"""The benchmark's harness on the CPU: cells resolve by name, a new cell,
traffic mix and per-layer metric are picked up from files alone, the
metric arithmetic on synthetic steps and traces, the import rule, and the
comparison's verdict on sound and on broken runs.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from benchtools import ROOT, tiny_checkout

from benchmark import check, devtrace, harness

BENCH = ROOT / "benchmark"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in _spec()["workloads"]])
def test_bench_every_cell_resolves_by_name(name):
    cell = harness.load_cell(name)
    assert cell.cfg["name"] == next(
        w for w in _spec()["workloads"] if w["name"] == name)["config"]
    assert callable(cell.scene.build) and callable(cell.engine.build)
    # a mesh's step tail is the slowest rank's host noise: no bound holds it
    assert {m["name"] for m in cell.e2e} == {
        "spp_per_s", "mrays_per_s", "setup_s",
        *(["step_ms_p95"] if cell.chips == 1 else [])}
    assert cell.layer and all(callable(r.read) for r in
                              cell.readers.values())
    assert check.compared(cell.limits)[:3] == [
        "pixel_gap_p90", "pixel_gap_mean", "count_gap"]
    assert int(cell.limits["pixels"]) > 0


def test_bench_contract_shape():
    spec = _spec()
    assert list(spec) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in spec["per_layer"]:
        assert (BENCH / "layer_metrics" / f"{m['name']}.py").is_file()


def test_bench_new_cell_traffic_and_metric_need_only_files(tmp_path):
    """A configuration, a traffic mix, an engine adapter and a per-layer
    metric written into a checkout are run with no edit of the harness."""
    root = tiny_checkout(tmp_path, engine="mega_copy", spp=2)
    bench = root / "benchmark"
    (bench / "engines" / "mega_copy.py").write_text(
        (bench / "engines" / "mega.py").read_text())
    (bench / "layer_metrics" / "scene_triangles.py").write_text(
        "def read(ctx):\n    return ctx.spans.get('scene_build') and 36\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append(dict(
        name="scene_triangles", unit="1", better="lower",
        source="program_counter", layer="scene build", moves="setup_s",
        workloads=["tiny-mega_copy"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("tiny-mega_copy", root)
    assert "scene_triangles" in cell.readers
    assert cell.traffic["engine"] == "mega_copy"
    result, lines = harness.run_cell(cell, 2**31 + 5, 0.2, False,
                                     torch.device("cpu"), 0.0)
    assert result["correct"], lines
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"spp_per_s", "mrays_per_s",
                                      "step_ms_p95", "setup_s"}
    assert list(result)[-1] == "check"
    assert lines[-4:] == check.lines(
        {k: v["value"] for k, v in result["check"].items()}, cell.limits)


def test_bench_end_to_end_arithmetic():
    times = [0.010] * 95 + [0.050] * 5
    stats = harness.end_to_end(times, [1e6] * 100, spp=4, window_s=2.0,
                               setup_s=7.5)
    assert stats["spp_per_s"] == 200.0
    assert stats["mrays_per_s"] == 50.0
    assert math.isclose(stats["step_ms_p95"], 12.0)
    assert stats["setup_s"] == 7.5


def _trace():
    # two steps on a 0-100 µs host window: device busy 10-30, 25-40, 70-90
    host = [("step.render", 0, 45), ("step.accumulate", 45, 50),
            ("step.readback", 50, 55), ("step.render", 55, 95),
            ("step.accumulate", 95, 97), ("step.readback", 97, 100)]
    device = [("void mcpt::render_mega_kernel<false, 0>(mcpt::Params)", 10,
               30), ("Memcpy DtoH (Device -> Pinned)", 25, 40),
              ("_ZN4mcpt19fused_bounce_kernelEv", 70, 90),
              ("void at::native::reduce_kernel<512>", 92, 94),
              ("Memcpy DtoH (Device -> Pinned)", 96, 97)]
    return SimpleNamespace(host=host, device=device)


def _read(name, **kw):
    ctx = SimpleNamespace(trace=_trace(), steps=2, segs=1e6, card_segs=1e6,
                          spans={})
    for k, v in kw.items():
        setattr(ctx, k, v)
    return harness._module(BENCH / "layer_metrics" / f"{name}.py").read(ctx)


def test_bench_trace_arithmetic():
    tr = _trace()
    assert devtrace.window(tr) == (0, 100)
    assert devtrace.union([(25, 40), (10, 30), (70, 90)]) == [[10, 40],
                                                             [70, 90]]
    assert devtrace.busy_us(tr) == 30 + 20 + 2 + 1
    gaps = devtrace.idle_gaps(tr)
    assert sum(us for _, us in gaps) == 100 - 53
    assert ("step.render", 10) in gaps  # 0-10, inside the first render
    assert ("step.readback", 30) in gaps  # 40-70: its middle, 55, ends it
    assert _read("device_idle_pct") == pytest.approx(47.0)
    assert _read("host_waits_per_step") == 1.0
    assert _read("engine_torch_ms_per_step") == pytest.approx(
        (15 + 2 + 1) / 1e3 / 2)
    assert _read("k1_mrays_per_s") == pytest.approx(1e6 / 20)
    assert _read("k2_mrays_per_s") == pytest.approx(1e6 / 20)
    assert _read("k3_mrays_per_s") is None
    assert _read("pilot_s") is None
    assert _read("scene_build_s", spans={"scene_build": 2.5}) == 2.5


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_bench_imports_no_jax_and_the_reference_nothing_of_the_port():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        tops = {name.split(".")[0] for name in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "mcpt"}, f
    for f in sorted((BENCH / "reference").rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(f)}
        assert "mcpt_torch" not in tops, f
    # whole top-level names: the port's name begins with the JAX package's
    assert "mcpt_torch".split(".")[0] not in harness.FORBIDDEN


def test_bench_run_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    assert harness.main(["--workload", "cbox-mega-step1", "--seed", "1",
                         "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


# the timed path broken underneath, once for each fault a cell can have
def _unchanged(step):
    def broken(seed, spp):
        radiance, segs = step(seed, spp)
        return torch.zeros_like(radiance), segs
    return broken


def _half_batch(step):
    def broken(seed, spp):
        radiance, segs = step(seed, spp // 2)
        return radiance * 2.0, segs * 2.0
    return broken


def _altered(step):
    def broken(seed, spp):
        radiance, segs = step(seed, spp)
        return radiance * 1.01, segs
    return broken


def _segments_miscounted(step):
    def broken(seed, spp):
        radiance, segs = step(seed, spp)
        return radiance, segs * 1.01
    return broken


@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch, _altered,
                                   _segments_miscounted])
def test_bench_broken_runs_read_not_correct(tmp_path, fault):
    root = tiny_checkout(tmp_path, engine="mega", spp=2)
    cell = harness.load_cell("tiny-mega", root)
    result, lines = harness.run_cell(cell, 991 + 2**32, 0.3, False,
                                     torch.device("cpu"), 0.0, fault)
    assert result["correct"] == (fault is None), lines


def test_bench_control_reads_above_every_cells_limits(tmp_path):
    """The float32 reference's bfloat16 twin in the program's place, at a
    size a test can hold: it fails the pixel comparison of every cell."""
    from benchmark.control import readings

    root = tiny_checkout(tmp_path, engine="mega", spp=2)
    cell = harness.load_cell("tiny-mega", root)
    prog = harness.build(cell, torch.device("cpu"))
    win = harness.window(cell, prog, 5, 0.3, False, torch.device("cpu"))
    pixels = harness.sample_pixels(5, 120, int(cell.limits["pixels"]))
    rad, count = harness.framebuffer_at(win.fb, pixels, "cpu")
    out = readings(cell, prog.scene, 5, win, rad, count, "cpu")
    assert check.verdict(out["program"], cell.limits)
    for f in sorted((BENCH / "limits").glob("*.json")):
        limits = json.loads(f.read_text())
        assert out["control"]["pixel_gap_p90"] > limits["pixel_gap_p90"], f
        assert out["control"]["pixel_gap_mean"] > limits["pixel_gap_mean"], f
    assert np.isfinite(out["control"]["step_segs_gap"])
