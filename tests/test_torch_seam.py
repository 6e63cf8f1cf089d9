"""The one seam between the kernels' Python side and the library
(``mcpt_torch.kernels._build``): every public dispatcher's device rule
(``use_kernel``) and the plain-on-card switch (``plain_versions``), on the
CPU."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from mcpt_torch import rng
from mcpt_torch import scenes as tscenes
from mcpt_torch.bvh.lbvh import one_thread
from mcpt_torch.kernels import _build
from mcpt_torch.kernels import cluster_megakernel as cmk
from mcpt_torch.kernels import fma_peak as fp
from mcpt_torch.kernels import megakernel as mk
from mcpt_torch.kernels import traverse_kernel as tk
from mcpt_torch.render.camera import make_camera
from mcpt_torch.scene import build_scene


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Loops of small CPU ops (``mcpt_torch.bvh.lbvh.one_thread``)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def inputs():
    """CPU inputs of every dispatcher at 4×4 pixels: quad_light's dense
    tables, boxfield(60)'s cluster tables and a 16-ray pool over them."""
    loaded, camcfg = tscenes.quad_light_plane()
    scene, lights = build_scene(loaded, device="cpu")
    mega = mk.build_megascene(scene, lights)
    mega_cam = make_camera(dataclasses.replace(camcfg, resolution=(4, 4)),
                           device="cpu")
    loaded, camcfg = tscenes.boxfield(60)
    scene, lights = build_scene(loaded, device="cpu")
    cms = cmk.build_cluster_megascene(scene, lights)
    cam = make_camera(dataclasses.replace(camcfg, resolution=(4, 4)),
                      device="cpu")
    state, rid = cmk.camera_pool(cms, cam, 4, 4, 1, seed=3, n_pool=128)
    return SimpleNamespace(mega=mega, mega_cam=mega_cam, cms=cms, cam=cam,
                           cl=scene.clusters, state=state, rid=rid)


# each public dispatcher, called with its deciding tensor (or device) on
# ``dev`` and everything else on the CPU
DISPATCHERS = {
    "render_mega": lambda i, dev: mk.render_mega(
        i.mega._replace(tri=i.mega.tri.to(dev)), i.mega_cam, 4, 4, spp=1,
        seed=0),
    "fused_bounce": lambda i, dev: cmk.fused_bounce(
        i.cms, i.state.clone().to(dev), i.rid, 5, 0, max_depth=2),
    "render_cluster_mega": lambda i, dev: cmk.render_cluster_mega(
        i.cms._replace(wnodes=i.cms.wnodes.to(dev)), i.cam, 4, 4, spp=1,
        seed=0, max_depth=2),
    "camera_pool": lambda i, dev: cmk.camera_pool(
        i.cms._replace(wnodes=i.cms.wnodes.to(dev)), i.cam, 4, 4, 1, 3, 128),
    "roulette": lambda i, dev: cmk.roulette(
        i.state.clone().to(dev), i.rid, 7, 2, 8.0),
    "sort_key": lambda i, dev: cmk.sort_key(
        i.state[0].to(dev), *i.state[1:6], i.state[cmk.ALIVE],
        i.cms.bb_lo, i.cms.bb_inv_ext),
    "reorder": lambda i, dev: cmk.reorder(
        i.state.to(dev), i.rid, torch.arange(128), 64,
        torch.zeros((), dtype=torch.float64)),
    "intersect_clusters": lambda i, dev: tk.intersect_clusters(
        i.cl, i.state[0:3].t().contiguous().to(dev),
        i.state[3:6].t().contiguous().to(dev)),
    "occluded_clusters": lambda i, dev: tk.occluded_clusters(
        i.cl, i.state[0:3].t().contiguous().to(dev),
        i.state[3:6].t().contiguous().to(dev), 1.0),
    "bits": lambda i, dev: rng.bits(rng.key(1), (8, 2), dev),
    "uniform": lambda i, dev: rng.uniform(rng.key(1), (8, 2), dev),
    "fma_chain": lambda i, dev: fp.fma_chain(
        torch.ones((fp.SUB, fp.COLS), device=dev), loops=1),
}


@pytest.mark.parametrize("name", sorted(DISPATCHERS))
def test_dispatchers_follow_the_one_device_rule(inputs, name):
    """A meta tensor raises, naming the dispatcher and "cpu or cuda"; a CPU
    call runs the plain version and counts no launch."""
    call = DISPATCHERS[name]
    with pytest.raises(ValueError, match=f"{name} runs on cpu or cuda"):
        call(inputs, "meta")
    before = _build.LAUNCHES.copy()
    call(inputs, "cpu")
    assert _build.LAUNCHES == before


def test_plain_versions_nests_and_restores_on_exceptions():
    """``plain_versions()`` turns CUDA to the plain versions, nests, and
    leaves the flag as it found it, an exception or not."""
    assert _build.use_kernel("x", "cuda") and not _build._PLAIN
    assert not _build.use_kernel("x", torch.zeros(1))
    with _build.plain_versions():
        assert not _build.use_kernel("x", "cuda")
        with pytest.raises(RuntimeError, match="inner"):
            with _build.plain_versions():
                assert _build._PLAIN
                raise RuntimeError("inner")
        assert _build._PLAIN and not _build.use_kernel("x", "cuda")
    assert not _build._PLAIN and _build.use_kernel("x", "cuda")
    with pytest.raises(ValueError, match="x runs on cpu or cuda"):
        with _build.plain_versions():
            _build.use_kernel("x", "meta")
    assert not _build._PLAIN
