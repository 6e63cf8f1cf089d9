"""The port's BVH quality metrics (SAH, EPO, LCV) against ``mcpt``'s.

- the clip of a triangle to a box: ``mcpt``'s cases
  (``tests/test_metrics.py:17-36``) to 1e-6 relative, and ``mcpt``'s clip on
  random pairs to 1e-12 relative (both clip in float64, the same operations
  in the same order; the tolerance allows XLA's contracted multiply-adds);
- EPO's host walk against ``mcpt.native.epo_native`` bit for bit (the same
  C++ code and flags, the same leaves in the same thread ranges);
- EPO's PyTorch walk against the host walk within 1e-6 relative, ``mcpt``'s
  own bound for its walk (``tests/test_metrics.py:113-130``): the two sum
  the same clips in another order, and the walk adds contained boxes' whole
  triangle areas without clipping;
- LCV against ``mcpt``'s on config 4's camera: exactly equal (the same
  float32 rays and slab tests give the same integer counts).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt import native
from mcpt import scenes as jscenes
from mcpt.bvh import lbvh as jlbvh
from mcpt.bvh import metrics as jmetrics
from mcpt.config import load_config as jload_config
from mcpt.render import camera as jcamera
from mcpt_torch.bvh import lbvh as tlbvh
from mcpt_torch.bvh import metrics as tmetrics
from mcpt_torch.bvh.lbvh import one_thread
from mcpt_torch.config import load_config
from mcpt_torch.render import camera as tcamera
from mcpt_torch.types import BVH

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Loops of small CPU ops; see ``mcpt_torch.bvh.lbvh.one_thread``."""
    with one_thread():
        yield


def _both_bvhs(verts):
    """``mcpt``'s LBVH of ``verts`` and the same tables as torch tensors
    (the port's LBVH equals it, ``test_torch_bvh``)."""
    jbvh = jlbvh.build_lbvh(jnp.asarray(verts))
    return jbvh, BVH(*(torch.from_numpy(np.array(getattr(jbvh, f)))
                       for f in BVH._fields))


def _random_tris(n, seed, scale=10.0):
    r = np.random.default_rng(seed)
    centre = r.uniform(-scale, scale, (n, 1, 3))
    return (centre + r.normal(0.0, 1.0, (n, 3, 3))).astype(np.float32)


def _clip(tris, bmin, bmax):
    return tmetrics._clip_areas(
        *(torch.as_tensor(np.asarray(a, np.float64)) for a in (tris, bmin,
                                                               bmax))).numpy()


@pytest.mark.parametrize("bmin,bmax,want", [
    # inside the box: the whole triangle
    ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0], 0.5),
    # the box keeps x ≤ 0.25: a trapezoid, ∫0^.25 (1-x) dx
    ([0.0, 0.0, 0.0], [0.25, 1.0, 1.0], 0.25 - 0.03125),
    # disjoint
    ([2.0, 2.0, 2.0], [3.0, 3.0, 3.0], 0.0),
])
def test_clip_area_cases(bmin, bmax, want):
    tris = np.array([[[0.0, 0.0, 0.5], [1.0, 0.0, 0.5], [0.0, 1.0, 0.5]]])
    got = _clip(tris, [bmin], [bmax])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if want == 0.0:
        assert got[0] == 0.0


def test_clip_area_full_inside():
    tris = np.array([[[0.1, 0.1, 0.5], [0.9, 0.1, 0.5], [0.1, 0.9, 0.5]]])
    np.testing.assert_allclose(_clip(tris, np.zeros((1, 3)), np.ones((1, 3))),
                               0.32, rtol=1e-6)


def test_clip_areas_equal_mcpt_on_random_pairs():
    r = np.random.default_rng(11)
    tris = r.uniform(-1.0, 1.0, (600, 3, 3))
    c = r.uniform(-0.5, 0.5, (600, 3))
    half = r.uniform(0.05, 1.0, (600, 3))
    with jax.enable_x64():  # mcpt's clip, compiled whole (eager: ~14 s)
        want = np.asarray(jax.jit(jmetrics._clip_areas_jnp)(
            jnp.asarray(tris), jnp.asarray(c - half), jnp.asarray(c + half)))
    got = _clip(tris, c - half, c + half)
    assert (want > 0).mean() > 0.5 and (want == 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_tri_area_equals_mcpt():
    verts = _random_tris(300, seed=2)
    np.testing.assert_array_equal(tmetrics.tri_area(verts),
                                  jmetrics.tri_area(verts))


@pytest.mark.parametrize("scene", ["boxfield60", "random"])
def test_epo_host_walk_equals_mcpt_native(scene):
    assert native.available()
    if scene == "random":
        verts = _random_tris(500, seed=4, scale=3.0)
    else:
        verts = jscenes.boxfield(60)[0].verts
    jbvh, tbvh = _both_bvhs(verts)
    want = native.epo_native(verts, np.asarray(jbvh.bbmin),
                             np.asarray(jbvh.bbmax), np.asarray(jbvh.left),
                             np.asarray(jbvh.right), jmetrics.C_INN,
                             jmetrics.C_TRI)
    assert tmetrics.epo(tbvh, verts) == want
    assert tmetrics.epo(tbvh, torch.from_numpy(verts),
                        use_native="always") == want


def test_epo_torch_walk_matches_host_walk():
    """boxfield(200), as ``mcpt``'s test of its walk; and a small chunk, so
    that lanes are refilled from the queue many times."""
    verts = jscenes.boxfield(200)[0].verts
    _, tbvh = _both_bvhs(verts)
    host = tmetrics.epo(tbvh, verts)
    walk = tmetrics.epo(tbvh, verts, use_native="never")
    assert abs(walk - host) <= 1e-6 * max(host, 1.0), (walk, host)
    small = _random_tris(300, seed=8, scale=2.0)
    _, sbvh = _both_bvhs(small)
    host = tmetrics.epo(sbvh, small)
    walk = tmetrics.epo(sbvh, small, chunk=37, use_native="never")
    assert host > 0.0
    assert abs(walk - host) <= 1e-6 * max(host, 1.0), (walk, host)


def test_epo_zero_for_separated_scene():
    base = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    verts = np.concatenate([base + np.array([i * 100.0, 0, 0], np.float32)
                            for i in range(16)])
    _, tbvh = _both_bvhs(verts)
    for mode in ("auto", "never"):
        assert tmetrics.epo(tbvh, verts, use_native=mode) == \
            pytest.approx(0.0, abs=1e-9)
    with pytest.raises(ValueError, match="use_native"):
        tmetrics.epo(tbvh, verts, use_native="sometimes")


@pytest.mark.parametrize("w,h", [(64, 64), (48, 32)])
def test_lcv_equals_mcpt_on_config4_camera(w, h):
    """Config 4 (cornell_box, testbvh) with its camera; exactly equal."""
    cfg = jload_config(os.path.join(ROOT, "config.json"), 4)
    tcfg = load_config(os.path.join(ROOT, "config.json"), 4)
    verts = jscenes.cornell_box()[0].verts
    jbvh, tbvh = _both_bvhs(verts)
    want = jmetrics.lcv(jbvh, jcamera.make_camera(cfg.camera), w, h)
    got = tmetrics.lcv(tbvh, tcamera.make_camera(tcfg.camera, device="cpu"),
                       w, h)
    assert got == want and got > 0.0


def test_lcv_equals_mcpt_on_a_deep_tree():
    """boxfield(60) from its own camera, 40×24: many leaves per ray."""
    jloaded, jcam = jscenes.boxfield(60)
    jbvh, tbvh = _both_bvhs(jloaded.verts)
    from mcpt_torch import scenes as tscenes

    tcam = tscenes.boxfield(60)[1]
    want = jmetrics.lcv(jbvh, jcamera.make_camera(jcam), 40, 24)
    got = tmetrics.lcv(tbvh, tcamera.make_camera(tcam, device="cpu"), 40, 24)
    assert got == want and got > 1.0


def test_sah_scale_free_and_equal_mcpt():
    verts = _random_tris(64, seed=1)
    jbvh, tbvh = _both_bvhs(verts)
    s1 = tmetrics.sah(tbvh)
    assert s1 == jmetrics.sah(jbvh) and s1 > 1.0
    s2 = tmetrics.sah(tlbvh.build_lbvh(torch.from_numpy(verts * 10.0)))
    assert abs(s1 - s2) < 1e-3 * s1


def test_lcv_single_triangle():
    verts = np.array([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float32)
    jbvh, tbvh = _both_bvhs(verts)
    cam = dataclasses.replace(load_config(os.path.join(ROOT, "config.json"),
                                          4).camera,
                              position=(0.0, 0.0, 5.0),
                              lookat=(0.0, 0.0, 0.0))
    got = tmetrics.lcv(tbvh, tcamera.make_camera(cam, device="cpu"), 16, 16)
    jcam = dataclasses.replace(jload_config(os.path.join(ROOT, "config.json"),
                                            4).camera,
                               position=(0.0, 0.0, 5.0),
                               lookat=(0.0, 0.0, 0.0))
    assert got == jmetrics.lcv(jbvh, jcamera.make_camera(jcam), 16, 16)
    assert got > 0.0
