"""The port's CUDA kernels on the card against their plain PyTorch versions.

Marked ``gpu``: without a CUDA device every test here skips (the kernels have
no CPU mode; their arithmetic is tested on the CPU through the plain version).
On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import dataclasses

import pytest
import torch

from mcpt_torch import scenes
from mcpt_torch.kernels import _build
from mcpt_torch.kernels import megakernel as mk
from mcpt_torch.render.camera import make_camera
from mcpt_torch.scene import build_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(name, w, h, device, **scene_kw):
    loaded, camcfg = getattr(scenes, name)(**scene_kw)
    scene, lights = build_scene(loaded, device=device)
    cam = make_camera(dataclasses.replace(camcfg, resolution=(w, h)),
                      device=device)
    return mk.build_megascene(scene, lights), cam


@pytest.mark.parametrize("name,depth", [("cornell_box", 16),
                                        ("veach_mis", 8),
                                        ("furnace_sphere", 8)])
@pytest.mark.parametrize("schedule", ["regen", "batch"])
def test_kernel_matches_plain_version(cuda, name, depth, schedule):
    """Built with -fmad=false, the kernel rounds as PyTorch's elementwise
    kernels do: the same bits on the same streams."""
    mega, cam = _setup(name, 24, 16, cuda)
    kw = dict(spp=3, seed=2, max_depth=depth, rr=True, nee=True, mis=True,
              schedule=schedule)
    before = mk.LAUNCHES
    a, sa = mk.render_mega(mega, cam, 24, 16, **kw)
    assert mk.LAUNCHES == before + 1
    b, sb = mk.render_mega_reference(mega, cam, 24, 16, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(sa) == float(sb)


def test_kernel_reads_large_tables_from_global_memory(cuda):
    """5440 triangle rows (371 KB of tables) exceed a block's 227 KB of
    shared memory: the kernel reads the tables from global memory, gives
    the plain version's bits, and the furnace identity still holds."""
    mega, cam = _setup("furnace_sphere", 16, 16, cuda, subdiv=4)
    rows = (mega.tri.shape[0], mega.matt.shape[0], mega.lit.shape[0],
            mega.cbox.shape[0])
    assert rows[0] == 5440 and not _build.load().mcpt_tables_in_smem(*rows)
    for kw in (dict(nee=True, mis=True), {}):
        a, sa = mk.render_mega(mega, cam, 16, 16, spp=4, seed=3, max_depth=6,
                               **kw)
        b, sb = mk.render_mega_reference(mega, cam, 16, 16, spp=4, seed=3,
                                         max_depth=6, **kw)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert float(sa) == float(sb)
    img = a.reshape(16, 16, 3) / 4.0  # BSDF sampling alone: exact
    torch.testing.assert_close(img[8, 8], torch.full_like(img[8, 8], 0.5),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(img[0, 0], torch.ones_like(img[0, 0]),
                               rtol=0, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    mega, cam = _setup("quad_light_plane", 8, 8, cuda)
    with pytest.raises(ValueError, match="float32"):
        mk.render_mega(mega._replace(tri=mega.tri.double()), cam, 8, 8,
                       spp=1, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        mk.render_mega(mega._replace(tri=mega.tri.t().contiguous().t()), cam,
                       8, 8, spp=1, seed=0)
    cpu_cam = cam._replace(position=cam.position.cpu())
    with pytest.raises((ValueError, RuntimeError)):
        mk.render_mega(mega, cpu_cam, 8, 8, spp=1, seed=0)


# --------------------------------------------------------------------------
# the hybrid engine's fused-bounce kernel (csrc/fused_bounce.cu)
# --------------------------------------------------------------------------


def _hybrid_setup(device, w=32, h=24, spp=2, seed=6):
    from mcpt_torch.kernels import cluster_megakernel as cmk

    loaded, camcfg = scenes.boxfield(60)
    scene, lights = build_scene(loaded, device=device)
    cam = make_camera(dataclasses.replace(camcfg, resolution=(w, h)),
                      device=device)
    cms = cmk.build_cluster_megascene(scene, lights)
    state, rid = cmk.camera_pool(cms, cam, w, h, spp, seed, n_pool=4096)
    return cmk, cms, cam, state, rid


def test_fused_bounce_matches_plain_version(cuda):
    """Depths 0-3 on boxfield(60), NEE+MIS+RR, each from the kernel's own
    previous output: radiance, alive and segments bit-equal on every lane,
    and every plane of the lanes still alive."""
    cmk, cms, _, state, rid = _hybrid_setup(cuda)
    kw = dict(max_depth=4, rr=True, rr_start=1, nee=True, mis=True)
    for depth in range(4):
        a, b = state.clone(), state.clone()
        before = cmk.LAUNCHES
        sa = cmk.fused_bounce(cms, a, rid, 6, depth, **kw)
        assert cmk.LAUNCHES == before + 1
        sb = cmk.fused_bounce_reference(cms, b, rid, 6, depth, **kw)
        assert torch.equal(sa, sb), depth
        for plane in range(9, 13):
            assert torch.equal(a[plane], b[plane]), (depth, plane)
        live = a[cmk.ALIVE] > 0
        assert torch.equal(a[:, live], b[:, live]), depth
        state = a


def test_render_hybrid_kernel_matches_plain_pipeline(cuda):
    cmk, cms, cam, _, _ = _hybrid_setup(cuda)
    for kw in (dict(key_mode="cell"),
               dict(key_mode="dir6", compact=(0.5, 0.3, 0.3))):
        kw = dict(kw, spp=4, seed=2, max_depth=4, nee=True, mis=True,
                  rr=True, rr_start=1)
        a, sa = cmk.render_hybrid(cms, cam, 32, 24, **kw)
        b, sb = cmk.render_hybrid_reference(cms, cam, 32, 24, **kw)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert float(sa) == float(sb)


def test_fused_bounce_stack_overflow_raises(cuda):
    """A (cyclic) wide node whose 8 always-hit children are itself pushes
    past STACK_CAP: the kernel sets its flag and the wrapper raises."""
    cmk, cms, _, state, rid = _hybrid_setup(cuda)
    row = torch.zeros(64, dtype=torch.float32)
    for k in range(8):
        row[6 * k: 6 * k + 3] = -1e30
        row[6 * k + 3: 6 * k + 6] = 1e30
    row[56:64] = float(sum(k << (3 * k) for k in range(8)))
    bad = cms._replace(wnodes=row[None].to(cuda))
    with pytest.raises(RuntimeError, match="stack overflow"):
        cmk.fused_bounce(bad, state.clone(), rid, 0, 0)


def test_fused_bounce_wrapper_refusals(cuda):
    cmk, cms, _, state, rid = _hybrid_setup(cuda)
    with pytest.raises(ValueError, match="float32"):
        cmk.fused_bounce(cms, state.double(), rid, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        cmk.fused_bounce(cms, state.t().contiguous().t(), rid, 0, 0)
    with pytest.raises(ValueError, match="rid"):
        cmk.fused_bounce(cms, state, rid.long(), 0, 0)
    with pytest.raises(ValueError, match="rid"):
        cmk.fused_bounce(cms, state, rid.cpu(), 0, 0)
    with pytest.raises(ValueError, match=r"\(16, N\)"):
        cmk.fused_bounce(cms, state[:15].contiguous(), rid, 0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        cmk.fused_bounce(cms._replace(tri16=cms.tri16.cpu()), state, rid, 0,
                         0)


# --------------------------------------------------------------------------
# the cluster megakernel (csrc/cluster_mega.cu) and the wavefront's cluster
# traversal (csrc/traverse.cu)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["regen", "batch"])
def test_cluster_mega_matches_plain_version(cuda, schedule):
    """Whole paths through the cluster walk on boxfield(60), NEE+MIS+RR:
    the plain version's bits, one launch."""
    cmk, cms, cam, _, _ = _hybrid_setup(cuda)
    kw = dict(spp=3, seed=4, max_depth=4, nee=True, mis=True, rr=True,
              rr_start=1, schedule=schedule)
    before = cmk.CLUSTER_MEGA_LAUNCHES
    a, sa = cmk.render_cluster_mega(cms, cam, 32, 24, **kw)
    assert cmk.CLUSTER_MEGA_LAUNCHES == before + 1
    b, sb = cmk.render_cluster_mega_reference(cms, cam, 32, 24, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(sa) == float(sb)


def _random_rays(device, n=20000, seed=8):
    import numpy as np

    r = np.random.default_rng(seed)
    o = r.uniform([-150, 0.5, -150], [150, 40, 150], (n, 3))
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = r.uniform(size=n) < 0.7
    limit = r.uniform(1.0, 300.0, n)
    t = (torch.from_numpy(o.astype("float32")).to(device),
         torch.from_numpy(d.astype("float32")).to(device),
         torch.from_numpy(active).to(device),
         torch.from_numpy(limit.astype("float32")).to(device))
    return t


def test_traverse_matches_plain_version(cuda):
    """Closest hit and any-hit of random rays, 30% inactive, with random
    limits: equal t, row, normal and occlusion, one launch each."""
    from mcpt_torch.kernels import traverse_kernel as tk

    loaded, _ = scenes.boxfield(60)
    scene, _ = build_scene(loaded, device=cuda)
    cl = scene.clusters
    o, d, active, limit = _random_rays(cuda)
    before = tk.LAUNCHES
    for any_hit in (False, True):
        a = tk._traverse(cl, o, d, active, limit, any_hit, 1e-4)
        b = tk.traverse_reference(cl, o, d, active, limit, any_hit, 1e-4)
        for x, y in zip(a if not any_hit else (a,), b if not any_hit
                        else (b,)):
            assert torch.equal(x, y), any_hit
    assert tk.LAUNCHES == before + 2
    hit = tk.intersect_clusters(cl, o, d, active=active)
    assert int((hit.tri >= 0).sum()) > 1000
    assert (hit.tri[~active] == -1).all()


def test_traverse_wrapper_refusals(cuda):
    from mcpt_torch.kernels import traverse_kernel as tk

    loaded, _ = scenes.boxfield(60)
    scene, _ = build_scene(loaded, device=cuda)
    cl = scene.clusters
    o, d, active, limit = _random_rays(cuda, n=256)
    with pytest.raises(ValueError, match="float32"):
        tk._traverse_cuda(cl, o.double(), d, active, limit, False)
    with pytest.raises(ValueError, match="contiguous"):
        tk._traverse_cuda(cl, o.t().contiguous().t(), d, active, limit,
                          False)
    with pytest.raises(ValueError, match="bool"):
        tk._traverse_cuda(cl, o, d, active.int(), limit, True)
    with pytest.raises(ValueError, match="CUDA"):
        tk._traverse_cuda(cl, o, d.cpu(), active, limit, True)
    with pytest.raises(ValueError, match="CUDA"):
        tk._traverse_cuda(cl._replace(tri16=cl.tri16.cpu()), o, d, active,
                          limit, False)


def test_cluster_mega_wrapper_refusals(cuda):
    cmk, cms, cam, _, _ = _hybrid_setup(cuda)
    with pytest.raises(ValueError, match="float32"):
        cmk.render_cluster_mega(cms._replace(tri16=cms.tri16.double()), cam,
                                8, 8, spp=1, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        cmk.render_cluster_mega(cms._replace(matt=cms.matt.cpu()), cam, 8, 8,
                                spp=1, seed=0)
    cpu_cam = cam._replace(position=cam.position.cpu())
    with pytest.raises((ValueError, RuntimeError)):
        cmk.render_cluster_mega(cms, cpu_cam, 8, 8, spp=1, seed=0)


def test_wavefront_on_cuda_goes_through_the_kernel(cuda):
    """A clustered scene on CUDA resolves to the cluster kernel: two
    launches a bounce (closest hit and NEE shadow rays), and the plain
    version's image."""
    from mcpt_torch import rng
    from mcpt_torch.kernels import traverse_kernel as tk
    from mcpt_torch.render import integrator as integ
    from mcpt_torch.render import traverse

    loaded, camcfg = scenes.boxfield(60)
    scene, lights = build_scene(loaded, device=cuda)
    cam = make_camera(dataclasses.replace(camcfg, resolution=(32, 24)),
                      device=cuda)
    assert traverse.resolve_method(scene) == "cluster"
    opts = integ.RenderOptions(max_depth=4, nee=True, mis=True,
                               russian_roulette=True, rr_start_depth=1,
                               resort=True)
    before = tk.LAUNCHES
    a, sa = integ.render_batch(scene, lights, cam, 32, 24, rng.key(2), opts,
                               spp=2, with_stats=True)
    assert tk.LAUNCHES == before + 2 * 4
    with tk.plain_version_on_cuda():
        b, sb = integ.render_batch(scene, lights, cam, 32, 24, rng.key(2),
                                   opts, spp=2, with_stats=True)
    assert tk.LAUNCHES == before + 2 * 4
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(sa) == float(sb)
