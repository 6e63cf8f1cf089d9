"""The port's cluster traversal (kernel 4's plain version) and cluster
megakernel (kernel 3's plain version) on the CPU.

- ``intersect_clusters`` / ``occluded_clusters`` against brute force over
  the same ``tri16`` rows, exactly (t, row, the any-hit at limits straddling
  each hit), and against ``mcpt``'s kernel in the Pallas interpreter on
  boxfield(60) camera rays (``tests/test_cluster.py:73, 122``): the same
  triangles, t within 5e-5 relative (XLA contracts multiply-adds in this
  process; the Wald quotient t = -op_z/dp_z turns that ulp into up to 3e-5,
  see ``test_torch_wavefront``);
- ``render_cluster_mega`` against ``mcpt``'s in the interpreter, in a child
  process without FMA (``test_torch_megakernel.jax_child``), under the dense
  path's gate (≥ 99% of pixels within |a-b| ≤ 1e-4·|b| + 1e-5, image means
  within 1e-3, segments within 0.1%);
- against the port's own dense megakernel and hybrid on the same streams:
  the same bits (the walk's (t, row) rule is brute force in row order, the
  dense megakernel's rule too).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt.pallas import traverse_kernel as jtk
from mcpt.scene import build_scene as jbuild_scene
from mcpt_torch import convert, rng
from mcpt_torch.bvh.lbvh import one_thread
from mcpt_torch import scenes as tscenes
from mcpt_torch.kernels import cluster_megakernel as cmk
from mcpt_torch.kernels import megakernel as mk
from mcpt_torch.kernels import traverse_kernel as tk
from mcpt_torch.render import camera as tcamera
from mcpt_torch.scene import build_scene
from test_torch_megakernel import assert_parity, jax_child


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run loops of small CPU ops; with several test workers on
    the same cores, PyTorch's intra-op threads spin against each other
    (``mcpt_torch.bvh.lbvh.one_thread``)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def boxfield60():
    loaded, camcfg = tscenes.boxfield(60)
    scene, lights = build_scene(loaded, device="cpu")
    from mcpt import scenes as jscenes

    jloaded, jcamcfg = jscenes.boxfield(60)
    jscene, _ = jbuild_scene(jloaded)
    return scene, lights, camcfg, jscene, jcamcfg


def _pool(camcfg, w, h, seed):
    cam = tcamera.make_camera(dataclasses.replace(camcfg, resolution=(w, h)),
                              device="cpu")
    return tcamera.generate_rays(cam, w, h, key=rng.key(seed))


def test_plain_traversal_equals_brute_force(boxfield60):
    """Camera rays and rays from random points in random directions, a third
    of them inactive: the closest hit is brute force over ``tri16`` (lowest
    t, then lowest row); the any-hit is brute force at limits below, at and
    above each hit."""
    scene, _, camcfg, _, _ = boxfield60
    cl = scene.clusters
    pool = _pool(camcfg, 40, 30, 1)
    r = np.random.default_rng(3)
    o = pool.origin.clone()
    o[600:] = torch.from_numpy(r.uniform([-150, 0.5, -150], [150, 40, 150],
                                         (600, 3)).astype(np.float32))
    d = pool.direction.clone()
    d[600:] = torch.nn.functional.normalize(
        torch.from_numpy(r.normal(size=(600, 3)).astype(np.float32)), dim=1)
    active = torch.arange(1200) % 3 != 1
    hit = tk.intersect_clusters(cl, o, d, active=active)
    want_t, want_row = mk._closest(cl.tri16, *o.unbind(1), *d.unbind(1),
                                   1e-4)
    want_hit = (want_t < 3e38) & active
    assert int(want_hit.sum()) > 400
    np.testing.assert_array_equal(
        hit.tri.numpy(),
        torch.where(want_hit, cl.tri_map[want_row], -1).numpy())
    assert torch.equal(hit.t[want_hit], want_t[want_hit])
    assert torch.isinf(hit.t[~want_hit]).all()
    assert torch.equal(hit.normal[want_hit], cl.tri16[want_row[want_hit],
                                                      12:15])
    assert torch.equal(hit.point[want_hit],
                       o[want_hit] + d[want_hit] * want_t[want_hit, None])
    limit = torch.where(want_t < 3e38, want_t, 500.0)
    for scale in (0.5, 1.0, 1.5):
        occ = tk.occluded_clusters(cl, o, d, limit * scale, active=active)
        want = mk._occluded(cl.tri16, *o.unbind(1), *d.unbind(1),
                            limit * scale, 1e-4) & active
        assert torch.equal(occ, want), scale
    # a limit below every hit: a miss, as the kernel's bound prunes it
    short = tk.intersect_clusters(cl, o, d, active=active, t_max=1e-3)
    assert (short.tri == -1).all()


def test_traversal_matches_mcpt_kernel(boxfield60):
    """``mcpt``'s block kernel (Pallas interpreter) on the shapes of
    ``tests/test_cluster.py``: 32×24 camera rays, every third inactive, and
    the any-hit at 1.2× and 0.8× the closest hit."""
    scene, _, camcfg, jscene, jcamcfg = boxfield60
    pool = _pool(camcfg, 32, 24, 0)
    o, d = pool.origin.numpy(), pool.direction.numpy()
    active = np.arange(768) % 3 != 0
    jcl = jscene.clusters
    want = jtk.intersect_clusters(jcl, jnp.asarray(o), jnp.asarray(d),
                                  active=jnp.asarray(active), interpret=True)
    got = tk.intersect_clusters(scene.clusters, pool.origin, pool.direction,
                                active=torch.from_numpy(active))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    hit = np.asarray(want.tri) >= 0
    assert hit.sum() > 100
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=5e-5)
    np.testing.assert_array_equal(got.normal.numpy()[hit],
                                  np.asarray(want.normal)[hit])
    tmax = np.where(hit, np.asarray(want.t), 100.0).astype(np.float32)
    for scale in (1.2, 0.8):
        jocc = jtk.occluded_clusters(jcl, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(tmax * scale),
                                     active=jnp.asarray(active),
                                     interpret=True)
        occ = tk.occluded_clusters(scene.clusters, pool.origin,
                                   pool.direction,
                                   torch.from_numpy(tmax * scale),
                                   active=torch.from_numpy(active))
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert not bool(occ.any())  # nothing lies before 0.8× the closest hit


def test_plain_versions_never_count_launches(boxfield60):
    scene, lights, camcfg, _, _ = boxfield60
    cms = cmk.build_cluster_megascene(scene, lights)
    cam = tcamera.make_camera(dataclasses.replace(camcfg, resolution=(4, 4)),
                              device="cpu")
    before = (tk.LAUNCHES, cmk.CLUSTER_MEGA_LAUNCHES, cmk.LAUNCHES)
    cmk.render_cluster_mega(cms, cam, 4, 4, spp=1, seed=0, max_depth=2)
    pool = _pool(camcfg, 4, 4, 0)
    tk.intersect_clusters(scene.clusters, pool.origin, pool.direction)
    assert (tk.LAUNCHES, cmk.CLUSTER_MEGA_LAUNCHES, cmk.LAUNCHES) == before


@pytest.mark.parametrize("schedule", ["regen", "batch"])
def test_cluster_mega_equals_dense_and_hybrid_streams(boxfield60, schedule):
    """The cluster megakernel and the dense megakernel in the same schedule,
    and in batch the hybrid without compaction, draw the same (sample,
    pixel) streams and resolve the same hits: the same bits.  (A regen lane
    sums its samples' radiance in another order than batch does.)"""
    scene, lights, camcfg, _, _ = boxfield60
    cam = tcamera.make_camera(dataclasses.replace(camcfg, resolution=(24, 16)),
                              device="cpu")
    cms = cmk.build_cluster_megascene(scene, lights)
    kw = dict(spp=2, seed=11, max_depth=4, nee=True, mis=True, rr=True,
              rr_start=1)
    a, sa = cmk.render_cluster_mega(cms, cam, 24, 16, schedule=schedule,
                                    **kw)
    b, sb = mk.render_mega(mk.build_megascene(scene, lights), cam, 24, 16,
                           schedule=schedule, **kw)
    assert float(a.sum()) > 0.0
    assert torch.equal(a, b) and float(sa) == float(sb)
    if schedule == "batch":
        c, sc = cmk.render_hybrid(cms, cam, 24, 16, compact=None, **kw)
        assert torch.equal(a, c) and float(sa) == float(sc)


_JAX_CLUSTER_MEGA = r"""
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from mcpt import scenes
from mcpt.pallas import cluster_megakernel as cmk
from mcpt.render import camera as cm
from mcpt.scene import build_scene
a = json.loads(sys.argv[1])
loaded, camcfg = scenes.boxfield(60)
camcfg = dataclasses.replace(camcfg, resolution=(a["w"], a["h"]))
scene, lights = build_scene(loaded)
rad, segs = cmk.render_cluster_mega(
    cmk.build_cluster_megascene(scene, lights), cm.make_camera(camcfg),
    a["w"], a["h"], interpret=True, **a["kw"])
np.savez(a["out"], rad=np.asarray(rad), segs=float(segs))
"""


def test_render_cluster_mega_matches_mcpt(tmp_path, boxfield60):
    """boxfield(60), 16×16, spp 2, depth 3, NEE+MIS+RR, regen."""
    scene, lights, camcfg, _, _ = boxfield60
    kw = dict(spp=2, seed=5, max_depth=3, nee=True, mis=True, rr=True,
              rr_start=1, schedule="regen")
    want = jax_child(tmp_path, _JAX_CLUSTER_MEGA, w=16, h=16, kw=kw)
    cam = tcamera.make_camera(dataclasses.replace(camcfg, resolution=(16, 16)),
                              device="cpu")
    got, segs = cmk.render_cluster_mega(
        cmk.build_cluster_megascene(scene, lights), cam, 16, 16, **kw)
    assert math.isfinite(float(segs)) and float(got.mean()) > 0.0
    assert_parity(got.numpy(), want["rad"], float(segs), float(want["segs"]))


def test_convert_round_trips(boxfield60):
    scene, _, camcfg, _, _ = boxfield60
    pool = _pool(camcfg, 8, 4, 2)
    back = convert.raypool_from_numpy(convert.raypool_to_numpy(pool), "cpu")
    for a, b in zip(pool, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    hit = tk.intersect_clusters(scene.clusters, pool.origin, pool.direction)
    back = convert.hit_from_numpy(convert.hit_to_numpy(hit), "cpu")
    for a, b in zip(hit, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jk = jax.random.fold_in(jax.random.key(3), 4)
    assert convert.key_from_data(jax.random.key_data(jk)) == \
        rng.fold_in(rng.key(3), 4)


def _mixed_rays(camcfg, n, seed):
    """Half camera rays, half rays from random points above the floor in
    random directions: (ox, oy, oz, dx, dy, dz) float32 planes."""
    r = np.random.default_rng(seed)
    o = r.uniform([-150, 0.5, -150], [150, 40, 150], (n, 3))
    o[: n // 2] = camcfg.position
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32))
            for x in (*o.T, *d.T)]


def test_walk_with_live_rows_equals_the_full_walk(boxfield60):
    """The walk that stops at each cluster's live rows gives the walk over
    every row's (t, row) and occlusion, and brute force's, on the same rays;
    only the rows it counts shrink, by the padding."""
    scene, lights, camcfg, _, _ = boxfield60
    cms = cmk.build_cluster_megascene(scene, lights)
    ray = _mixed_rays(camcfg, 2000, seed=12)
    cmk.WALK_WORK.update(boxes=0, rows=0, all_rows=0)
    t_live, row_live = cmk.walk_tables(cms, *ray, 1e-4)
    live_work = dict(cmk.WALK_WORK)
    cmk.WALK_WORK.update(boxes=0, rows=0, all_rows=0)
    t_all, row_all = cmk.walk_reference(cms.wnodes, cms.tri16, cms.leaf_size,
                                        *ray, 1e-4)
    all_work = dict(cmk.WALK_WORK)
    want_t, want_row = mk._closest(cms.tri16, *ray, 1e-4)
    assert int((want_t < 3e38).sum()) > 400
    for got_t, got_row in ((t_live, row_live), (t_all, row_all)):
        assert torch.equal(got_t, want_t) and torch.equal(got_row, want_row)
    assert live_work["boxes"] == all_work["boxes"]
    assert live_work["all_rows"] == all_work["all_rows"] == all_work["rows"]
    assert 0 < live_work["rows"] < all_work["rows"]
    limit = torch.where(want_t < 3e38, want_t, 500.0)
    for scale in (0.5, 1.0, 1.5):
        occ = cmk.walk_tables(cms, *ray, 1e-4, limit * scale)
        occ_all = cmk.walk_reference(cms.wnodes, cms.tri16, cms.leaf_size,
                                     *ray, 1e-4, limit * scale)
        want = mk._occluded(cms.tri16, *ray, limit * scale, 1e-4)
        assert torch.equal(occ, want) and torch.equal(occ_all, want), scale


def _visits(cms, o, d, t_min=1e-4):
    """One ray's closest-hit walk, scalar by scalar in float32 numpy, in the
    plain walk's order → the clusters it tests, in order."""
    w = cms.wnodes.numpy()
    tri16 = cms.tri16.numpy()
    live = cms.live.numpy()
    nw, t = w.shape[0], cms.leaf_size
    f = np.float32
    inv = [f(1.0) / (f(1e-30) * (f(-1) if x < 0 else f(1))
                     if abs(x) < f(1e-30) else x) for x in d]
    octant = int(d[0] > 0) + 2 * int(d[1] > 0) + 4 * int(d[2] > 0)
    best = f(3.0e38)
    stack, seen = [0], []
    while stack:
        node = stack.pop()
        if node >= nw:
            c = node - nw
            seen.append(c)
            th, ok = mk._wald(torch.from_numpy(tri16[c * t: c * t + live[c]]),
                              tuple(torch.tensor(f(x)) for x in o),
                              tuple(torch.tensor(f(x)) for x in d), t_min,
                              3.0e38)
            if bool(ok.any()):
                best = min(best, f(th[ok].min()))
            continue
        box = w[node, :48].reshape(8, 6)
        t0 = [(box[:, j] - f(o[j])) * inv[j] for j in range(3)]
        t1 = [(box[:, 3 + j] - f(o[j])) * inv[j] for j in range(3)]
        tn = np.maximum(np.maximum(np.minimum(t0[0], t1[0]),
                                   np.minimum(t0[1], t1[1])),
                        np.minimum(t0[2], t1[2]))
        tf = np.minimum(np.minimum(np.maximum(t0[0], t1[0]),
                                   np.maximum(t0[1], t1[1])),
                        np.maximum(t0[2], t1[2]))
        hit = (tf >= np.maximum(tn, f(0))) & (tn <= best)
        code = int(w[node, 56 + octant])
        for j in range(8):
            k = (code >> (3 * j)) & 7
            if hit[k]:
                stack.append(int(w[node, 48 + k]))
    return seen


def test_walk_work_counts_the_live_rows_of_the_visited_clusters(boxfield60):
    """WALK_WORK's rows are the sum of ``live`` over the clusters the walk
    visits (counted by a scalar walk of each ray), and its all_rows the
    leaf size times the visits: the counts behind chip_smoke.py's bounds."""
    scene, lights, camcfg, _, _ = boxfield60
    cms = cmk.build_cluster_megascene(scene, lights)
    ray = _mixed_rays(camcfg, 96, seed=5)
    cmk.WALK_WORK.update(boxes=0, rows=0, all_rows=0)
    cmk.walk_tables(cms, *ray, 1e-4)
    visits = [_visits(cms, [float(x[i]) for x in ray[:3]],
                      [np.float32(x[i]) for x in ray[3:]])
              for i in range(96)]
    flat = [c for v in visits for c in v]
    assert len(flat) > 40
    assert cmk.WALK_WORK["rows"] == int(cms.live.numpy()[flat].sum())
    assert cmk.WALK_WORK["all_rows"] == cms.leaf_size * len(flat)
