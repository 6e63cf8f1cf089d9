"""The benchmark's plain reference on the CPU, at tiny sizes: its inputs
equal the port's scenes and tables, its intersector equals a brute-force
one, and it renders the samples the port's plain engines render, path for
path.

    python -m pytest benchmark/tests -q
"""

import numpy as np
import pytest
import torch
from benchtools import ROOT  # noqa: F401  (puts the checkout on sys.path)

from benchmark.reference import render as reference
from benchmark.reference import tables
from benchmark.reference.hits import Hits, wald
from benchmark.scenes import cornell_box, diningroom

FIELDS = ("verts", "mat_id", "mtype", "kd", "ks", "ka", "ns", "ni")
INTEGRATOR = dict(nee=True, mis=True, russian_roulette=True,
                  rr_start_depth=3, clamp=0.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _program(scene, width, height):
    from mcpt_torch.config import CameraConfig
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.scene import build_scene, loaded_from_arrays

    loaded = loaded_from_arrays(*(scene[k] for k in FIELDS))
    prog_scene, lights = build_scene(loaded, "hlbvh", device="cpu")
    cam = make_camera(CameraConfig(resolution=(width, height),
                                   **scene["camera"]), device="cpu")
    return prog_scene, lights, cam


@pytest.fixture(scope="module")
def dining():
    scene = diningroom.build()
    return scene, _program(scene, 16, 9)


@pytest.mark.parametrize("name", ["cornell_box", "diningroom"])
def test_bench_scenes_equal_the_ports_procedural_scenes(name):
    from mcpt_torch import scenes

    ours = {"cornell_box": cornell_box, "diningroom": diningroom}[name]
    scene = ours.build()
    loaded, cam = getattr(scenes, name)()
    for k in FIELDS:
        np.testing.assert_array_equal(scene[k], getattr(loaded, k))
    for k, v in scene["camera"].items():
        assert tuple(np.atleast_1d(getattr(cam, k))) == \
            tuple(np.atleast_1d(v))


def test_bench_tables_equal_the_ports_kernel_tables():
    from mcpt_torch.kernels import megakernel as mk

    scene = cornell_box.build()
    prog_scene, lights, cam = _program(scene, 20, 14)
    mega = mk.build_megascene(prog_scene, lights)
    tab = tables.build(scene)
    np.testing.assert_array_equal(tab.rows, mega.tri[:len(tab.rows)].numpy())
    np.testing.assert_array_equal(tab.lit, mega.lit.numpy())
    np.testing.assert_array_equal(tab.matt,
                                  mega.matt[:len(tab.matt), :12].numpy())
    assert (tab.eps, tab.total_light_area) == (mega.eps,
                                               mega.total_light_area)
    sf = mk._sf(mega, cam, 1e-4, 0.0).numpy()
    np.testing.assert_array_equal(
        np.float32(tables.camera(scene["camera"], 20, 14).sf)[:14], sf[:14])


@pytest.mark.parametrize("chunk", [4, 64])
def test_bench_hits_equal_brute_force(chunk):
    """Culling by chunk boxes loses no hit: the closest t and its row, and
    the any-hit answer, equal a test of every row in scene order."""
    scene = cornell_box.build()
    tab = tables.build(scene)
    hits = Hits(tab.rows, tab.verts, "cpu", chunk=chunk)
    g = torch.Generator().manual_seed(3)
    n = 2000
    o = tuple(torch.rand(n, generator=g) * 500.0 + 20.0 for _ in range(3))
    d = torch.randn(3, n, generator=g)
    d = tuple(d / d.norm(dim=0))
    t, rows = hits.closest(o, d, 1e-4)
    a = torch.from_numpy(tab.rows)
    th, ok = wald(a[None], tuple(x[:, None] for x in o),
                  tuple(x[:, None] for x in d), 1e-4, 3.0e38)
    th = torch.where(ok, th, np.inf)
    m = th.min(dim=1).values
    first = torch.where(th == m[:, None], torch.arange(len(a)),
                        len(a)).min(dim=1).values
    hit = m < np.inf
    assert hit.sum() > n // 2
    assert torch.equal(t[hit], m[hit])
    assert torch.equal(rows[hit], a[first[hit]])
    assert (t[~hit] == 3.0e38).all()
    limit = torch.where(hit, m * 0.5, 100.0)
    th2, ok2 = wald(a[None], tuple(x[:, None] for x in o),
                    tuple(x[:, None] for x in d), 1e-4, limit[:, None])
    assert torch.equal(hits.occluded(o, d, limit, 1e-4), ok2.any(dim=1))


@pytest.mark.parametrize("schedule", ["batch", "regen"])
def test_bench_reference_renders_the_dense_plain_version(schedule):
    """Every sample of two steps at every pixel: the reference's sums and
    segments equal the port's plain kernel 1 (whose CUDA kernel is held
    to it bit for bit)."""
    from mcpt_torch.kernels import megakernel as mk

    w, h, spp = 14, 10, 2
    scene = cornell_box.build()
    prog_scene, lights, cam = _program(scene, w, h)
    mega = mk.build_megascene(prog_scene, lights)
    seeds = [2**31 + 12345, 77]
    fb = torch.zeros(w * h, 3, dtype=torch.float64)
    segs = 0.0
    for s in seeds:
        r, sg = mk.render_mega(mega, cam, w, h, spp=spp, seed=s,
                               max_depth=16, rr=True, rr_start=3, nee=True,
                               mis=True, schedule=schedule)
        fb += r.double()
        segs += float(sg)
    cfg = dict(width=w, height=h, maxdepth=16, t_min=1e-4,
               integrator=INTEGRATOR)
    rad, rsegs = reference.render_pixels(
        *reference.prepare(scene, cfg, "cpu"), np.arange(w * h), seeds, spp)
    np.testing.assert_allclose(rad, fb.numpy(), rtol=1e-6, atol=1e-6)
    assert rsegs.sum() == segs


@pytest.mark.parametrize("engine", ["cluster_mega", "hybrid"])
def test_bench_reference_renders_the_cluster_plain_versions(dining,
                                                            engine):
    """The dining room's samples through the port's plain cluster walk
    (kernel 3's plain version, and the hybrid's pipeline with kernel 2's):
    the same sums and segments as the reference's own intersector."""
    from mcpt_torch.kernels import cluster_megakernel as cmk

    scene, (prog_scene, lights, cam) = dining
    cms = cmk.build_cluster_megascene(prog_scene, lights)
    w, h, spp, seed = 16, 9, 1, 4242
    render = (cmk.render_cluster_mega if engine == "cluster_mega"
              else cmk.render_hybrid)
    r, sg = render(cms, cam, w, h, spp=spp, seed=seed, max_depth=8, rr=True,
                   rr_start=3, nee=True, mis=True)
    cfg = dict(width=w, height=h, maxdepth=8, t_min=1e-4,
               integrator=INTEGRATOR)
    rad, rsegs = reference.render_pixels(
        *reference.prepare(scene, cfg, "cpu"), np.arange(w * h), [seed],
        spp)
    np.testing.assert_allclose(rad, r.double().numpy(), rtol=1e-6,
                               atol=1e-6)
    assert rsegs.sum() == float(sg)
