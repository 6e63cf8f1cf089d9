"""A cell on several ranks (``benchmark/ranks.py``) on the CPU: two gloo
ranks of a tiny 12×10 hybrid cell with a ``{"samples": 2}`` mesh, each
started as on the cards (rank 0 by ``mesh_rank0.py``, which skips the look
for a card), against one rank of the same seeds, broken underneath, and
with a rank that fails; a one-card cell spawns nothing.  Each run has its
own time limit.

    python -m pytest benchmark/tests -q
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from benchtools import ROOT, TINY_CFG, tiny_checkout

from benchmark import devtrace, harness, ranks

BENCH = ROOT / "benchmark"
HERE = Path(__file__).resolve().parent
MESH_CFG = {**TINY_CFG, "scene": "cornell_tess", "mesh": {"samples": 2}}
LIMIT_S = 100  # each run's; a test's whole time stays under 120 s
SEED = 2**33 + 11

# engine adapters that break the sharded hybrid underneath, on one rank or
# on every rank, written into the test's checkout
ADAPTERS = {
    "doubled_shard": '''
from benchmark.engines import hybrid_mesh


def build(scene, cfg, device, span, mesh):
    import torch.distributed as td
    from mcpt_torch.kernels import cluster_megakernel as cmk

    if td.get_rank() == 1:  # this rank's rows, before the all-reduce
        render = cmk.render_hybrid

        def doubled(*args, **kw):
            rad, segs = render(*args, **kw)
            return rad * 2.0, segs
        cmk.render_hybrid = doubled
    return hybrid_mesh.build(scene, cfg, device, span, mesh)
''',
    "no_exchange": '''
from benchmark.engines import hybrid_mesh


def build(scene, cfg, device, span, mesh):
    from mcpt_torch import dist

    dist.Mesh._all_reduce = lambda self, t, group: t
    return hybrid_mesh.build(scene, cfg, device, span, mesh)
''',
    "raises": '''
from benchmark.engines import hybrid_mesh


def build(scene, cfg, device, span, mesh):
    import torch.distributed as td

    step = hybrid_mesh.build(scene, cfg, device, span, mesh)
    calls = []

    def failing(seed, spp):
        calls.append(seed)
        if td.get_rank() == 1 and len(calls) == 3:
            raise RuntimeError("rank 1 fails in its third step")
        return step(seed, spp)
    return failing
''',
}


def mesh_checkout(tmp: Path, engine: str = "hybrid_mesh") -> tuple:
    """A checkout with one cell ``tiny-<engine>`` on 2 ranks → (root, its
    name)."""
    root = tiny_checkout(tmp, engine=engine, spp=2, cfg=MESH_CFG)
    shutil.copy(HERE / "cornell_tess.py", root / "benchmark" / "scenes")
    if engine in ADAPTERS:
        (root / "benchmark" / "engines" / f"{engine}.py").write_text(
            ADAPTERS[engine])
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"][0]["chips"] = 2
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, f"tiny-{engine}"


def rank0(root: Path, name: str, *extra) -> tuple:
    """Rank 0 of the cell in a process of its own → (completed process,
    seconds it took)."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, str(HERE / "mesh_rank0.py"), str(root), name,
         str(SEED), "1.0", *extra], capture_output=True, text=True,
        timeout=LIMIT_S, env={**os.environ, "OMP_NUM_THREADS": "1"})
    return proc, time.monotonic() - t0


def left_behind(root: Path) -> list:
    """Processes whose command line names the checkout (its ranks)."""
    out = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                if str(root).encode() in (d / "cmdline").read_bytes():
                    out.append(int(d.name))
            except OSError:
                pass
    return out


def result_of(proc) -> dict:
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_two_ranks_match_one_rank(tmp_path):
    root, name = mesh_checkout(tmp_path)
    steps = tmp_path / "steps.npz"
    proc, _ = rank0(root, name, "--steps", str(steps))
    assert proc.returncode == 0, proc.stderr
    result = result_of(proc)
    assert result["correct"], proc.stderr
    assert result["device"]["count"] == 2
    assert "2 ranks, mesh {'samples': 2, 'pixels': 1}, backend gloo" \
        in proc.stderr
    # every step rank 0 rendered (warm-up and window), against one rank
    # rendering both samples of the same seed: equal to float32 order
    rec = np.load(steps)
    assert len(rec["seeds"]) == 1 + result["attempted"]
    scene = harness._module(root / "benchmark" / "scenes"
                            / "cornell_tess.py").build()
    step = harness._module(BENCH / "engines" / "hybrid.py").build(
        scene, MESH_CFG, torch.device("cpu"), contextlib.nullcontext)
    for seed, rad in zip(rec["seeds"], rec["radiance"]):
        one, _ = step(int(seed), 2)
        np.testing.assert_allclose(rad, one.numpy(), rtol=1e-5, atol=1e-6)
    assert left_behind(root) == []


@pytest.mark.parametrize("fault", ["doubled_shard", "no_exchange"])
def test_bench_broken_mesh_reads_not_correct(tmp_path, fault):
    root, name = mesh_checkout(tmp_path, fault)
    proc, _ = rank0(root, name)
    assert proc.returncode == 0, proc.stderr
    assert result_of(proc)["correct"] is False, proc.stderr
    assert left_behind(root) == []


def test_bench_a_rank_that_fails_ends_the_run(tmp_path):
    root, name = mesh_checkout(tmp_path, "raises")
    proc, took = rank0(root, name)
    # rank 0's watchdog, or its own collective with the rank that died
    assert proc.returncode != 0, proc.stderr
    assert proc.stdout.strip() == ""
    assert "rank 1 fails in its third step" in proc.stderr
    assert took < LIMIT_S / 2
    assert left_behind(root) == []


def test_bench_one_card_cell_spawns_nothing(tmp_path, monkeypatch):
    """A cell on one card: no rank started, no group made, no
    ``step.agree`` in its trace, the same fields from ``load_cell``."""
    def refuse(*args, **kw):
        raise AssertionError("a one-card cell started ranks")

    monkeypatch.setattr(ranks, "start", refuse)
    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    root = tiny_checkout(tmp_path, engine="mega", spp=2)
    cell = harness.load_cell("tiny-mega", root)
    assert cell.chips == 1 and "mesh" not in cell.cfg
    assert set(vars(cell)) == {"name", "chips", "cfg", "traffic", "e2e",
                               "layer", "limits", "scene", "engine",
                               "readers"}
    prog = harness.build(cell, torch.device("cpu"))
    win = harness.window(cell, prog, 3, 0.2, True, torch.device("cpu"))
    tr = devtrace.from_profile(win.prof)
    assert {n for n, _, _ in tr.host} == {"step.render", "step.accumulate",
                                          "step.readback"}
    assert win.agree_s == 0.0
    result, lines = harness.run_cell(cell, SEED, 0.2, False,
                                     torch.device("cpu"), 0.0)
    assert result["correct"], lines
    assert "ranks" not in lines[0]
    assert not torch.distributed.is_initialized()


def test_bench_idle_gaps_name_the_innermost_span_of_a_recorded_trace():
    """A recorded profile: a gap inside the hybrid's raygen is the
    raygen's, one inside the ranks' agreement is ``step.agree``'s, not
    ``step.render``'s."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mcpt_torch.trace import span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("step.render"):
            with span("mcpt.hybrid.raygen"):
                time.sleep(0.02)
        with record_function("step.agree"):
            time.sleep(0.02)
    tr = devtrace.from_profile(prof)
    (_, r0, r1), (_, a0, _) = sorted(tr.host, key=lambda x: x[1])
    # the card busy from the render's end to the agreement's start
    tr.device = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", r1, a0)]
    labels = [label for label, _ in devtrace.idle_gaps(tr)]
    assert labels == ["mcpt.hybrid.raygen", "step.agree"]


NCCL_ROWS = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)"
NCCL_SEGS = "ncclDevKernel_AllReduce_Sum_f64_RING_LL(y)"


def _collective_trace():
    """Two traced steps on rank 0's card: each step's rows all-reduce (the
    first waits 20 µs for the slowest rank, the second none) with c10d's
    ``nccl:all_reduce`` range around it, the segments' all-reduce, and
    kernel 2."""
    return SimpleNamespace(host=[("step.render", 0, 200)], device=[
        ("nccl:all_reduce", 9, 41), (NCCL_ROWS, 10, 40),
        ("nccl:all_reduce", 49, 53), (NCCL_SEGS, 50, 52),
        ("_ZN4mcpt19fused_bounce_kernelEv", 60, 90),
        ("nccl:all_reduce", 109, 121), (NCCL_ROWS, 110, 120),
        ("nccl:all_reduce", 129, 133), (NCCL_SEGS, 130, 132),
        ("_ZN4mcpt19fused_bounce_kernelEv", 140, 170)])


@pytest.mark.parametrize("name, ms", [
    # each kernel's shortest launch, twice a step: (10 + 2) µs a step
    ("collective_ms_per_step", 12 / 1e3),
    # the rest: the rows' first launch waited 20 µs, over 2 steps
    ("lockstep_wait_ms_per_step", 20 / 1e3 / 2)])
def test_bench_collective_reader(name, ms):
    """The NCCL kernels alone, not c10d's ranges around them."""
    reader = harness._module(BENCH / "layer_metrics" / f"{name}.py")
    ctx = SimpleNamespace(trace=_collective_trace(), steps=2)
    assert reader.read(ctx) == pytest.approx(ms)
    ctx.trace.device = [x for x in ctx.trace.device
                        if not x[0].startswith("nccl")]
    assert reader.read(ctx) is None


def test_bench_device_ranges_are_not_device_work():
    """``from_profile`` keeps a user range's device-side echo (the
    harness's, c10d's ``nccl:all_reduce``) out of the device's work."""
    from torch.autograd import DeviceType

    def ev(name, s, e, device, annotation=False):
        return SimpleNamespace(
            name=name, time_range=SimpleNamespace(start=s, end=e),
            device_type=device, is_user_annotation=annotation,
            device_time_total=0.0)

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    prof = SimpleNamespace(events=lambda: [
        ev("step.render", 0, 100, cpu), ev("step.render", 0, 100, cuda),
        ev("nccl:all_reduce", 9, 41, cpu),
        ev("nccl:all_reduce", 9, 41, cuda, True), ev(NCCL_ROWS, 10, 40, cuda),
        ev("_ZN4mcpt19fused_bounce_kernelEv", 50, 60, cuda),
        ev("Memcpy DtoH (Device -> Pageable)", 70, 77, cuda)])
    tr = devtrace.from_profile(prof)
    assert [n for n, _, _ in tr.device] == [
        NCCL_ROWS, "_ZN4mcpt19fused_bounce_kernelEv",
        "Memcpy DtoH (Device -> Pageable)"]
    # the copy alone: kernel 2 is the program's, NCCL's the collectives'
    reader = harness._module(BENCH / "layer_metrics"
                             / "engine_torch_ms_per_step.py")
    assert reader.read(SimpleNamespace(trace=tr, steps=1)) == \
        pytest.approx(7 / 1e3)


def test_bench_kernel_rate_takes_rank_0s_share():
    """On a mesh, kernel 2's rate divides rank 0's share of the segments
    (the harness's ``card_segs``) by rank 0's kernel time."""
    reader = harness._module(BENCH / "layer_metrics" / "k2_mrays_per_s.py")
    ctx = SimpleNamespace(trace=_collective_trace(), steps=2, segs=4e6,
                          card_segs=1e6)
    assert reader.read(ctx) == pytest.approx(1e6 / 60)


def test_bench_ranks_environment():
    """torchrun's variables, and one host thread a rank."""
    env = ranks._environ(2, 4, 29500)
    assert env == dict(RANK="2", WORLD_SIZE="4", LOCAL_RANK="2",
                       LOCAL_WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT="29500", OMP_NUM_THREADS="1")
