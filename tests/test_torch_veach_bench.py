"""The benchmark's Veach MIS deployment (config ``veach``) on the CPU: its
scene equals the port's ``veach_mis()``, the scene takes kernel 1's
chunked tier, and the port's plain kernel 1 renders the samples the
benchmark's plain reference renders, path for path, at the configuration's
depth 16 without Russian roulette."""

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
from benchmark.reference import path, tables  # noqa: E402
from benchmark.reference import render as reference  # noqa: E402
from benchmark.reference.hits import Hits  # noqa: E402
from benchmark.scenes import veach_mis  # noqa: E402

FIELDS = ("verts", "mat_id", "mtype", "kd", "ks", "ka", "ns", "ni")
W, H, SPP = 24, 16, 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def veach():
    """(benchmark scene, configuration at the test's view, the port's
    megascene and camera)."""
    from mcpt_torch.config import CameraConfig
    from mcpt_torch.kernels import megakernel as mk
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.scene import build_scene, loaded_from_arrays

    scene = veach_mis.build()
    cfg = dict(harness.load_cell("veach-mega-step64").cfg, width=W,
               height=H)
    loaded = loaded_from_arrays(*(scene[k] for k in FIELDS))
    prog_scene, lights = build_scene(loaded, cfg["bvhtype"], device="cpu")
    cam = make_camera(CameraConfig(resolution=(W, H), **scene["camera"]),
                      device="cpu")
    return scene, cfg, mk.build_megascene(prog_scene, lights), cam


def test_bench_veach_scene_equals_the_ports_veach_mis():
    from mcpt_torch import scenes

    scene = veach_mis.build()
    loaded, cam = scenes.veach_mis()
    for k in FIELDS:
        np.testing.assert_array_equal(scene[k], getattr(loaded, k))
        assert scene[k].dtype == getattr(loaded, k).dtype, k
    for k, v in scene["camera"].items():
        assert tuple(np.atleast_1d(getattr(cam, k))) == \
            tuple(np.atleast_1d(v))
    assert scene["verts"].shape == (332, 3, 3)


def test_veach_takes_the_chunked_tier(veach):
    """332 triangles: ``render_cli``'s ``auto`` sends the scene to kernel
    1, and kernel 1 culls by 21 chunk boxes of 16 rows."""
    from mcpt_torch.kernels import megakernel as mk
    from mcpt_torch.render_cli import MEGA_MAX_TRIS

    _, _, mega, _ = veach
    assert mega.n_tris == 332 <= MEGA_MAX_TRIS
    assert mk.tier(mega.n_tris) == "chunked"
    assert mega.cbox.shape == (21, 8)


@pytest.mark.parametrize("seeds", [(2**31 + 12345, 77),
                                   (3_000_000_019, 5)])
def test_veach_chunked_plain_kernel_renders_the_reference(veach, seeds):
    """Two steps of 2 spp at every pixel: the same radiance sums and the
    same segments as the benchmark's reference (the CUDA kernel 1 is held
    to this plain version bit for bit)."""
    from mcpt_torch.kernels import megakernel as mk

    scene, cfg, mega, cam = veach
    integ = cfg["integrator"]
    assert (cfg["maxdepth"], integ["russian_roulette"]) == (16, False)
    rad_prog, segs_prog = [], 0.0
    for s in seeds:
        r, sg = mk.render_mega(mega, cam, W, H, spp=SPP, seed=s,
                               max_depth=cfg["maxdepth"], rr=False,
                               rr_start=integ["rr_start_depth"],
                               nee=integ["nee"], mis=integ["mis"],
                               clamp=integ["clamp"], t_min=cfg["t_min"])
        rad_prog.append(r.double())
        segs_prog += float(sg)
    rad, segs = reference.render_pixels(
        *reference.prepare(scene, cfg, "cpu"), np.arange(W * H), seeds, SPP)
    # each path's radiance is the same float32 arithmetic on both sides;
    # the program adds a step's 2 samples in float32, the reference every
    # sample in float64: a relative gap of a few 2^-24 (1e-6 leaves 10x);
    # 1e-6 absolute for the pixels that gather nothing
    np.testing.assert_allclose(rad, sum(rad_prog).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert segs.sum() == segs_prog


def test_veach_view_sees_every_plate_and_light():
    """The compared view holds the four Phong plates (Ns 5000 to 20) and
    the lights: primary rays of the test's 24×16 view hit each."""
    scene = veach_mis.build()
    tab = tables.build(scene)
    sf = tables.camera(scene["camera"], W, H).sf
    pix = torch.arange(W * H)
    seed = torch.full_like(pix, 77)
    o, d = path.camera_ray(sf, seed, pix, pix, W, H, torch.float32)
    o = [x + torch.zeros(W * H) for x in o]
    t, rows = Hits(tab.rows, tab.verts, "cpu").closest(o, d, 1e-4)
    seen = set(rows[t < path.MISS, 15].long().tolist())
    assert {1, 2, 3, 4} <= seen  # the plates
    assert seen & {5, 6, 7, 8}  # a light


# the per-layer metrics without a list of cells, which every cell reports
EVERY_CELL = {"host_waits_per_step", "engine_torch_ms_per_step",
              "device_idle_pct", "scene_build_s"}


def test_veach_cell_resolves():
    """The cell's configuration, traffic, scene, engine, limits and
    readers are found by name; it reports the step tail, kernel 1's rate
    and the engine's idle as the Cornell-box cells do, and its limits
    compare exact counts."""
    cell = harness.load_cell("veach-mega-step64")
    assert cell.chips == 1
    assert cell.limits["count_gap"] == 0.0
    assert cell.limits["pixels"] >= 128
    assert callable(cell.scene.build) and callable(cell.engine.build)
    assert {m["name"] for m in cell.e2e} == {
        "spp_per_s", "mrays_per_s", "step_ms_p95", "setup_s"}
    assert set(cell.readers) == EVERY_CELL | {"k1_mrays_per_s",
                                              "engine_idle_ms_per_step"}


@pytest.mark.parametrize("name", [
    "void mcpt::render_mega_kernel<true, 0>(mcpt::Params, float const*)",
    "_ZN4mcpt18render_mega_kernelILb1ELi0EEEvNS_6ParamsEPKf"])
def test_k1_mrays_per_s_reads_the_chunked_tier(name):
    """The veach cell's kernel is kernel 1's chunked instantiation, as the
    trace names it demangled or mangled: 4e6 segments over its 1000 µs
    read 4,000 Mrays/s, and other kernels do not count."""
    device = [(name, 0, 600), ("void at::native::reduce_kernel<512>", 600,
                               700), (name, 700, 1100)]
    ctx = SimpleNamespace(trace=SimpleNamespace(host=[], device=device),
                          steps=2, segs=4e6, card_segs=4e6, spans={})
    reader = harness.load_cell("veach-mega-step64").readers["k1_mrays_per_s"]
    assert reader.read(ctx) == pytest.approx(4000.0)
