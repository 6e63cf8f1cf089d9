"""The port's hybrid engine against ``mcpt``'s, on the CPU (plain versions).

- the plain cluster walk against brute force over the same ``tri16`` rows:
  the closest hit's t and row, and the any-hit, exactly;
- the sort keys against ``mcpt._hybrid_sort_key`` bit for bit, in all four
  key modes, dead lanes included; ``_compaction_schedule`` and
  ``resolve_key_mode`` against ``mcpt``'s;
- ``render_hybrid`` against ``mcpt``'s ``render_hybrid`` in the Pallas
  interpreter, in a child process without FMA (see
  ``test_torch_megakernel``), on ``mcpt``'s own tables and camera handed over
  through ``mcpt_torch.convert``.  Gate: the dense path's
  (``test_torch_megakernel.assert_parity``: ≥ 99% of pixels within
  |a-b| ≤ 1e-4·|b| + 1e-5, image means within 1e-3, segments within 0.1%):
  the two walks differ only on exact t ties across clusters, and XLA's
  transcendentals by an ulp.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt.pallas import cluster_megakernel as jcmk
from mcpt_torch import convert
from mcpt_torch import scenes as tscenes
from mcpt_torch.kernels import cluster_megakernel as cmk
from mcpt_torch.kernels import megakernel as mk
from mcpt_torch.render.camera import make_camera
from mcpt_torch.scene import build_scene
from test_torch_megakernel import assert_parity, jax_child

_JAX_HYBRID = r"""
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from mcpt import scenes
from mcpt.pallas import cluster_megakernel as cmk
from mcpt.render import camera as cm
from mcpt.scene import build_scene
a = json.loads(sys.argv[1])
loaded, camcfg = getattr(scenes, a["scene"])(**a["scene_kw"])
camcfg = dataclasses.replace(camcfg, resolution=(a["w"], a["h"]))
scene, lights = build_scene(loaded)
cms = cmk.build_cluster_megascene(scene, lights)
cam = cm.make_camera(camcfg)
kw = dict(a["kw"])
if kw.get("compact") is not None:
    kw["compact"] = tuple(kw["compact"])
rad, segs = cmk.render_hybrid(cms, cam, a["w"], a["h"], interpret=True, **kw)
out = {"cms_" + k: np.asarray(v) for k, v in cms._asdict().items()}
out.update({"cam_" + k: np.asarray(v) for k, v in cam._asdict().items()})
np.savez(a["out"], rad=np.asarray(rad), segs=float(segs), **out)
"""


@pytest.fixture(scope="module")
def boxfield60():
    loaded, camcfg = tscenes.boxfield(60)
    scene, lights = build_scene(loaded, device="cpu")
    return cmk.build_cluster_megascene(scene, lights), camcfg


def _rays(camcfg, n, seed):
    """Rays from the camera and from random points above the boxfield's
    floor, in random directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-150.0, 0.5, -150.0], [150.0, 40.0, 150.0], (n, 3))
    o[: n // 2] = camcfg.position
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = [torch.from_numpy(np.ascontiguousarray(x, np.float32))
         for x in (*o.T, *d.T)]
    return t


def test_walk_equals_brute_force(boxfield60):
    cms, camcfg = boxfield60
    ray = _rays(camcfg, 3000, seed=1)
    best_t, best_row = cmk.walk_reference(cms.wnodes, cms.tri16,
                                          cms.leaf_size, *ray, 1e-4)
    want_t, want_row = mk._closest(cms.tri16, *ray, 1e-4)
    assert int((best_t < 3e38).sum()) > 600  # the rays do hit geometry
    torch.testing.assert_close(best_t, want_t, rtol=0, atol=0)
    torch.testing.assert_close(best_row, want_row, rtol=0, atol=0)

    # any-hit at limits straddling each closest hit
    limit = torch.where(want_t < 3e38, want_t, 500.0)
    for scale in (0.5, 1.0, 1.5):
        occ = cmk.walk_reference(cms.wnodes, cms.tri16, cms.leaf_size, *ray,
                                 1e-4, limit * scale)
        want = mk._occluded(cms.tri16, *ray, limit * scale, 1e-4)
        assert torch.equal(occ, want), scale


@pytest.mark.parametrize("mode", ["cell", "dir", "dir6", "dir9"])
def test_sort_keys_equal_mcpt(mode):
    rng = np.random.default_rng(7)
    n = 4096
    o = rng.uniform(-12.0, 12.0, (n, 3)).astype(np.float32)  # some outside
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8] = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1], [0, 0, 0], [1, 1, 1]])
    alive = (rng.uniform(size=n) < 0.7).astype(np.float32)
    lo, inv = (-10.0, -9.0, -8.0), (0.05, 0.06, 0.07)
    want = np.asarray(jcmk._hybrid_sort_key(
        *(jnp.asarray(x) for x in (*o.T, *d.T, alive)), lo, inv,
        cmk.COARSE_BITS, mode))
    got = cmk._hybrid_sort_key(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in (*o.T, *d.T, alive)), lo, inv, mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[alive == 0] == cmk.DEAD_KEY).all()


@pytest.mark.parametrize("rows0,depth,compact", [
    (64, 8, None), (900, 8, (0.9, 0.6, 0.45, 0.3, 0.2)),
    (33 * 32, 6, (0.5, 0.25)), (32, 4, (0.01,)),
    (2880, 8, (0.98, 0.97, 0.95, 0.93, 0.9, 0.88, 0.86)),
])
def test_compaction_schedule_equals_mcpt(rows0, depth, compact):
    """``mcpt``'s schedule with every bounce re-sorting and 32-row blocks,
    the port's only setting."""
    assert cmk._compaction_schedule(rows0, depth, compact) == \
        jcmk._compaction_schedule(rows0, depth, 1, compact, cmk.SUBT)


@pytest.mark.parametrize("w,h,block", [(16, 16, 4096), (64, 36, 4096),
                                       (160, 90, 4096), (37, 23, 1024)])
def test_tile_order_equals_mcpt(w, h, block):
    from mcpt.render.camera import tile_order as jtile_order
    from mcpt_torch.render.camera import tile_order

    for got, want in zip(tile_order(w, h, block), jtile_order(w, h, block)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_resolve_key_mode_equals_mcpt():
    for c in (None, (), (0.9, 0.85), (0.9, 0.5), (0.8,)):
        for mode in ("auto", "cell", "dir6"):
            assert cmk.resolve_key_mode(mode, c) == \
                jcmk.resolve_key_mode(mode, c)


def test_fused_bounce_passes_dead_lanes_through(boxfield60):
    """A lane with alive == 0 keeps every plane and traces 0 segments; the
    plain version never counts a kernel launch."""
    cms, camcfg = boxfield60
    cam = make_camera(dataclasses.replace(camcfg, resolution=(16, 8)),
                      device="cpu")
    state, rid = cmk.camera_pool(cms, cam, 16, 8, 1, seed=5, n_pool=4096)
    state[cmk.ALIVE, ::3] = 0.0
    before = state.clone()
    launches = cmk.LAUNCHES
    segs = cmk.fused_bounce(cms, state, rid, 5, 0, max_depth=4, nee=True,
                            mis=True, rr=True)
    assert cmk.LAUNCHES == launches
    dead = before[cmk.ALIVE] == 0.0
    assert torch.equal(state[:, dead], before[:, dead])
    assert float(segs[dead].abs().sum()) == 0.0
    assert float(segs[~dead].sum()) >= int((~dead).sum())


def jax_render_hybrid(tmp_path, w, h, **kw):
    z = jax_child(tmp_path, _JAX_HYBRID, scene="boxfield",
                  scene_kw={"n_boxes": 60}, w=w, h=h, kw=kw)
    cms = convert.clustermegascene_from_numpy(
        {k[4:]: v for k, v in z.items() if k.startswith("cms_")}, "cpu")
    cam = convert.camera_from_numpy(
        {k[4:]: v for k, v in z.items() if k.startswith("cam_")}, "cpu")
    return z["rad"], float(z["segs"]), cms, cam


@pytest.mark.parametrize("w,h,kw", [
    # open scene, no compaction, origin-first keys
    (16, 16, dict(spp=2, seed=4, max_depth=3, nee=True, mis=True, rr=True,
                  rr_start=1, key_mode="cell", compact=None)),
    # 8192 rays in 64 pool rows: the tight caps shrink the pool to 32 rows
    # after bounce 0, with Bernoulli roulette and a tail slice
    (64, 64, dict(spp=2, seed=9, max_depth=3, nee=True, mis=True, rr=True,
                  rr_start=1, key_mode="dir6", compact=[0.3, 0.2])),
    # NEE without MIS, a clamp, "dir" keys, deeper paths
    pytest.param(32, 32, dict(spp=2, seed=17, max_depth=5, nee=True,
                              mis=False, clamp=2.0, key_mode="dir",
                              compact=None),
                 marks=pytest.mark.slow),
])
def test_render_hybrid_matches_mcpt(tmp_path, boxfield60, w, h, kw):
    want, s_want, cms, cam = jax_render_hybrid(tmp_path, w, h, **kw)
    # mcpt's tables are the port's (tests/test_torch_bvh.py); hand them over
    # anyway, so this compares the renderers alone
    own, _ = boxfield60
    assert torch.equal(cms.tri16, own.tri16)
    kw = dict(kw, compact=tuple(kw["compact"]) if kw["compact"] else None)
    got, s_got = cmk.render_hybrid(cms, cam, w, h, **kw)
    assert math.isfinite(float(s_got))  # no NaN canary from a live tail
    assert_parity(got.numpy(), want, float(s_got), s_want)


def test_profile_hybrid_gives_render_hybrids_bits(boxfield60):
    cms, camcfg = boxfield60
    cam = make_camera(dataclasses.replace(camcfg, resolution=(64, 64)),
                      device="cpu")
    kw = dict(spp=2, seed=1, max_depth=3, nee=True, mis=True, rr=True,
              rr_start=1, compact=(0.3, 0.2))
    a, sa = cmk.render_hybrid(cms, cam, 64, 64, **kw)
    timer, b, sb = cmk.profile_hybrid(cms, cam, 64, 64, **kw)
    assert torch.equal(a, b) and float(sa) == float(sb)
    names = set(timer.totals)
    assert {"raygen", "roulette", "final-reduce"} <= names
    assert any(n.startswith("bounce[d2]") for n in names)
    assert any(n.startswith("sort[d0]") for n in names)
