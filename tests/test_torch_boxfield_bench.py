"""The benchmark's open box field (config ``boxfield``, config.json entry
7) on the CPU: its scene equals the port's ``boxfield()``, the port's
hybrid renders the samples the benchmark's plain reference renders, path
for path, with the pilot's caps and the origin-first sort key, every pool
shrink keeps every live lane (so the compaction roulette, which the
reference does not model, never draws), and the cell resolves with its
metrics, including the kernel-2 lane counter's reader."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.engines.program import build_inputs  # noqa: E402
from benchmark.reference import render as reference  # noqa: E402
from benchmark.scenes import boxfield  # noqa: E402

FIELDS = ("verts", "mat_id", "mtype", "kd", "ks", "ka", "ns", "ni")
CELL = "boxfield-hybrid-step4"
W, H, SPP = 32, 18, 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _view(cfg, w, h):
    return dict(cfg, width=w, height=h)


@pytest.fixture(scope="module")
def field():
    """(benchmark scene, the cell's configuration, the port's cluster
    tables, {(w, h): camera})."""
    from mcpt_torch.kernels import cluster_megakernel as cmk

    scene = boxfield.build()
    cfg = harness.load_cell(CELL).cfg
    prog_scene, lights, _ = build_inputs(scene, _view(cfg, W, H), "cpu")
    cms = cmk.build_cluster_megascene(prog_scene, lights)
    cams = {(w, h): build_inputs(scene, _view(cfg, w, h), "cpu")[2]
            for w, h in ((W, H), (64, 36))}
    return scene, cfg, cms, cams


def _pilot_caps(cms, cam, cfg, w, h):
    """The pilot's caps at the view's own size: ``measure_hybrid_schedule``
    (1 spp, seed 0, no NEE, the origin-first key) at w × h."""
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.render import integrator as integ

    fracs: list = []
    integ_cfg = cfg["integrator"]
    cmk._run_hybrid(cms, cam, w, h, 1, 0, max_depth=cfg["maxdepth"],
                    rr=integ_cfg["russian_roulette"],
                    rr_start=integ_cfg["rr_start_depth"], key_mode="cell",
                    live=fracs)
    return integ._schedule_from(fracs, 1.35)


def _render(cms, cam, cfg, w, h, spp, seed, compact, key_mode="auto",
            live=None):
    from mcpt_torch.kernels import cluster_megakernel as cmk

    i = cfg["integrator"]
    return cmk._run_hybrid(
        cms, cam, w, h, spp, seed, max_depth=cfg["maxdepth"],
        rr=i["russian_roulette"], rr_start=i["rr_start_depth"], nee=i["nee"],
        mis=i["mis"], clamp=i["clamp"], t_min=cfg["t_min"], compact=compact,
        key_mode=key_mode, live=live)


def test_bench_boxfield_scene_equals_the_ports_boxfield():
    from mcpt_torch import scenes

    scene = boxfield.build()
    loaded, cam = scenes.boxfield()
    for k in FIELDS:
        np.testing.assert_array_equal(scene[k], getattr(loaded, k))
        assert scene[k].dtype == getattr(loaded, k).dtype, k
    for k, v in scene["camera"].items():
        assert tuple(np.atleast_1d(getattr(cam, k))) == \
            tuple(np.atleast_1d(v))
    assert scene["verts"].shape == (108_004, 3, 3)
    assert scene["mtype"][scene["mat_id"][-2:]].tolist() == [4, 4]  # sky


@pytest.mark.parametrize("seeds", [(2**31 + 12345, 77),
                                   (3_000_000_019, 5)])
def test_boxfield_hybrid_renders_the_reference(field, seeds):
    """Two steps of 2 spp at every pixel of a 32×18 view, depth 8,
    NEE + MIS + roulette from depth 3, the caps of that size's pilot and
    the key they resolve to (``cell``): the same radiance sums and
    segments as the benchmark's reference (the CUDA kernels are held to
    these plain versions bit for bit)."""
    from mcpt_torch.kernels import cluster_megakernel as cmk

    scene, cfg, cms, cams = field
    cam = cams[W, H]
    caps = _pilot_caps(cms, cam, cfg, W, H)
    assert cmk.resolve_key_mode("auto", caps) == "cell"
    rad_prog, segs_prog = [], 0.0
    for s in seeds:
        r, sg = _render(cms, cam, cfg, W, H, SPP, s, caps)
        rad_prog.append(r.double())
        segs_prog += float(sg)
    rad, segs = reference.render_pixels(
        *reference.prepare(scene, _view(cfg, W, H), "cpu"),
        np.arange(W * H), seeds, SPP)
    # each path's radiance is the same float32 arithmetic on both sides;
    # the program adds a step's 2 samples in float32, the reference every
    # sample in float64: a relative gap of a few 2^-24 (1e-6 leaves 10x);
    # 1e-6 absolute for the pixels that gather nothing (rays that leave
    # the field)
    np.testing.assert_allclose(rad, sum(rad_prog).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert segs.sum() == segs_prog
    assert (rad.sum(axis=1) == 0).any()  # some paths escape at once


@pytest.mark.parametrize("view", [(W, H, SPP), (64, 36, 8)])
def test_boxfield_shrinks_keep_every_live_lane(field, view):
    """At each shrink of the pool the live lanes fit in 97% of the next
    pool, so the compaction roulette keeps each with p = 1 and the render
    equals the one without caps bit for bit.  32×18 at 2 spp fills one
    pool quantum (32 rows), which no cap shrinks; 64×36 at 8 spp (160
    rows) shrinks twice under its pilot's caps."""
    from mcpt_torch.kernels import cluster_megakernel as cmk

    w, h, spp = view
    _, cfg, cms, cams = field
    cam = cams[w, h]
    caps = _pilot_caps(cms, cam, cfg, w, h)
    n_rays = w * h * spp
    rows = cmk._compaction_schedule(-(-n_rays // cmk.BLKT) * cmk.SUBT,
                                    cfg["maxdepth"], caps)
    shrinks = [d for d in range(len(rows) - 1) if rows[d + 1] < rows[d]]
    assert len(shrinks) == (0 if n_rays <= cmk.BLKT else 2)
    live: list = []
    r, sg = _render(cms, cam, cfg, w, h, spp, 2**32 + 99, caps, live=live)
    for d in shrinks:
        assert round(live[d] * n_rays) <= 0.97 * rows[d + 1] * 128, d
    r0, sg0 = _render(cms, cam, cfg, w, h, spp, 2**32 + 99, None,
                      key_mode="cell")
    assert torch.equal(r, r0) and float(sg) == float(sg0)


# the per-layer metrics without a list of cells, which every cell reports
EVERY_CELL = {"host_waits_per_step", "engine_torch_ms_per_step",
              "device_idle_pct", "scene_build_s"}


def test_boxfield_cell_resolves():
    """The cell's configuration, traffic, scene, engine, limits and
    readers are found by name: the hybrid at 4 spp a step on one card,
    reporting what the dining room's hybrid cell reports and the lanes
    kernel 2 is launched over."""
    cell = harness.load_cell(CELL)
    assert cell.chips == 1
    assert (cell.cfg["scene"], cell.cfg["width"], cell.cfg["height"],
            cell.cfg["maxdepth"]) == ("boxfield", 1280, 720, 8)
    assert cell.traffic["engine"] == "hybrid"
    assert cell.traffic["spp_per_step"] == 4
    assert cell.limits["count_gap"] == 0.0
    assert cell.limits["pixels"] >= 128
    assert callable(cell.scene.build) and callable(cell.engine.build)
    assert {m["name"] for m in cell.e2e} == {
        "spp_per_s", "mrays_per_s", "step_ms_p95", "setup_s"}
    hybrid = {"k2_mrays_per_s", "hybrid_sort_ms_per_step",
              "program_waits_per_step", "engine_idle_ms_per_step",
              "pilot_s", "k2_mlanes_per_step"}
    assert set(cell.readers) == EVERY_CELL | hybrid
    assert set(harness.load_cell("diningroom-hybrid-step4").readers) == \
        EVERY_CELL | hybrid


def _trace():
    # two steps on a 0-100 µs host window; the card is busy 10-30, 25-40,
    # 70-90, 92-94 and 96-97
    host = [("step.render", 0, 45), ("step.accumulate", 45, 50),
            ("step.readback", 50, 55), ("step.render", 55, 95),
            ("step.accumulate", 95, 97), ("step.readback", 97, 100)]
    device = [("_ZN4mcpt19fused_bounce_kernelEv", 10, 30),
              ("Memcpy DtoH (Device -> Pinned)", 25, 40),
              ("_ZN4mcpt19fused_bounce_kernelEv", 70, 90),
              ("void at::native::reduce_kernel<512>", 92, 94),
              ("Memcpy DtoH (Device -> Pinned)", 96, 97)]
    return SimpleNamespace(host=host, device=device)


# the program's spans of those steps: (name, start, end, device µs)
PROGRAM = [("mcpt.hybrid.raygen", 1, 8, 0.0),
           ("mcpt.hybrid.bounce", 9, 42, 35.0),
           ("mcpt.wait.k2_flag", 31, 41, 15.0),
           ("mcpt.hybrid.sort", 42, 44, 0.0),
           ("mcpt.hybrid.bounce", 55, 89, 0.0),
           ("mcpt.hybrid.sort", 60, 68, 20.0),
           ("mcpt.wait.k2_flag", 69, 89, 0.0),
           ("mcpt.hybrid.reduce", 90, 94, 2.0)]
# the counter's empty ranges, one at the start of each bounce; the second
# sits at the middle of the card's idle gap 40-70
COUNTS = [("mcpt.count.k2_lanes=3686400", 9, 9, 0.0),
          ("mcpt.count.k2_lanes=1572864", 55, 55, 0.0)]


def _read(name, program):
    ctx = SimpleNamespace(trace=_trace(), steps=2, segs=1e6, card_segs=1e6,
                          spans={},
                          program_spans=sorted(program, key=lambda x: x[1]))
    return harness.load_cell(CELL).readers[name].read(ctx)


def test_k2_mlanes_per_step_sums_the_counter():
    """3,686,400 + 1,572,864 lanes over two steps: 2.629632 M a step;
    nothing to read in a trace without the counter (the parent's)."""
    assert _read("k2_mlanes_per_step", PROGRAM + COUNTS) == \
        pytest.approx(5_259_264 / 1e6 / 2)
    assert _read("k2_mlanes_per_step", PROGRAM) is None


@pytest.mark.parametrize("name", ["program_waits_per_step",
                                  "engine_idle_ms_per_step",
                                  "hybrid_sort_ms_per_step"])
def test_span_readers_read_the_same_with_the_counter(name):
    """The counter's ranges are no wait, no sort and hold no device time;
    one at the middle of an idle gap inside a bounce takes the gap's label
    from the bounce, and the gap stays the program's."""
    assert _read(name, PROGRAM + COUNTS) == _read(name, PROGRAM)
    assert _read(name, PROGRAM) is not None
