"""The one seam between the kernels' Python side and the library
(``mcpt_torch.kernels._build``): every public dispatcher's device rule
(``use_kernel``), the plain-on-card switch (``plain_versions``) and the
deferred stack-overflow flags (``overflow_checked_once``), on the CPU."""

import collections
import dataclasses
import re
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

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


K2, K4 = "mcpt_fused_bounce", "mcpt_traverse"


def _flag_ranges(body):
    """body() under a CPU profiler → (the RuntimeError it raised or None,
    Counter of the mcpt. ranges it left)."""
    raised = None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        try:
            body()
        except RuntimeError as e:
            raised = e
    return raised, collections.Counter(
        e.name for e in prof.events() if e.name.startswith("mcpt."))


def _two_kernels(set_k2: bool, set_k4: bool):
    """Three kernel-2 launches and two kernel-4 launches on one device in
    one block, with each kernel's flag set or not."""
    dev = torch.device("cpu")
    with _build.overflow_checked_once():
        k2 = [_build.overflow_flag(K2, dev, 40) for _ in range(3)]
        k4 = [_build.overflow_flag(K4, dev, 50) for _ in range(2)]
        assert all(f is k2[0] for f in k2) and all(f is k4[0] for f in k4)
        assert k2[0] is not k4[0]
        for flag, symbol, cap in ((k2[0], K2, 40), (k4[0], K4, 50)):
            _build.check_overflow(symbol, flag, cap)  # deferred: no read
        k2[0].fill_(int(set_k2))
        k4[0].fill_(int(set_k4))


@pytest.mark.parametrize("k2_set,k4_set,message", [
    (False, False, None),
    (True, False, r"fused bounce: traversal stack overflow \(> 40 entries"),
    (False, True, r"traverse: stack overflow \(> 50 entries"),
    (True, True, r"fused bounce: traversal stack overflow \(> 40 entries"),
])
def test_overflow_checked_once_reads_each_kernels_flag(k2_set, k4_set,
                                                        message):
    """Two kernels' launches on one device in one block: a flag each,
    shared by that kernel's launches and read once at the block's end under
    its own wait span, after a ``flags_deferred`` count of the launches it
    covers; a set flag raises its kernel's message (kernel 2's is read
    first, as it was handed out first) and leaves no block open."""
    raised, ranges = _flag_ranges(lambda: _two_kernels(k2_set, k4_set))
    assert _build._DEFERRED is None
    if message is None:
        assert raised is None
        assert ranges == {"mcpt.count.flags_deferred=3": 1,
                          "mcpt.wait.k2_flag": 1,
                          "mcpt.count.flags_deferred=2": 1,
                          "mcpt.wait.k4_flag": 1}
    else:
        assert raised is not None and re.search(message, str(raised))
        assert ranges["mcpt.wait.k2_flag"] == 1
        assert ranges["mcpt.wait.k4_flag"] == int(not k2_set)


@pytest.mark.parametrize("symbol,cap,message", [
    (K2, 40, r"fused bounce: traversal stack overflow \(> 40"),
    (K4, 50, r"traverse: stack overflow \(> 50"),
])
def test_overflow_flag_outside_a_block_is_read_at_once(symbol, cap,
                                                       message):
    """Outside a block each launch's flag is fresh and zero, and
    ``check_overflow`` reads it at once under its kernel's span (no
    ``flags_deferred`` count): clean, nothing; set, it raises there."""
    dev = torch.device("cpu")
    flag = _build.overflow_flag(symbol, dev, cap)
    assert int(flag.item()) == 0
    wait = _build.OVERFLOW_READS[symbol][0]
    raised, ranges = _flag_ranges(
        lambda: _build.check_overflow(symbol, flag, cap))
    assert raised is None and ranges == {wait: 1}
    flag.fill_(1)
    raised, ranges = _flag_ranges(
        lambda: _build.check_overflow(symbol, flag, cap))
    assert re.search(message, str(raised)) and ranges == {wait: 1}
    assert _build._DEFERRED is None


def test_hybrid_step_runs_its_bounces_in_one_block(inputs, monkeypatch):
    """``render_hybrid`` (and the pilot and the sharded hybrid, through
    ``_run_hybrid``) runs every bounce inside one open
    ``overflow_checked_once`` block, and leaves none open."""
    seen = []
    bounce = cmk.fused_bounce

    def watched(*args, **kwargs):
        seen.append(_build._DEFERRED)
        return bounce(*args, **kwargs)

    monkeypatch.setattr(cmk, "fused_bounce", watched)
    cmk.render_hybrid(inputs.cms, inputs.cam, 4, 4, spp=1, seed=0,
                      max_depth=3)
    assert len(seen) == 3 and seen[0] is not None
    assert all(block is seen[0] for block in seen)
    assert _build._DEFERRED is None
