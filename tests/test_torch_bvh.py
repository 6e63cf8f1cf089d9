"""The port's acceleration structures against ``mcpt``'s, array for array.

LBVH topology and boxes, the treelet optimisers (the C++ one ``mcpt`` builds
scenes with, and the numpy one), the cluster plans, the 8-wide collapse and
the cluster tables must all be equal: exact equality, no tolerance, since
the hybrid engine's hits and so its pixels follow from these tables.
"""

import numpy as np
import pytest
import torch

from mcpt import scenes as jscenes
from mcpt.bvh import cluster as jcluster
from mcpt.bvh import lbvh as jlbvh
from mcpt.bvh import treelet as jtreelet
from mcpt.scene import build_scene as jbuild_scene
from mcpt_torch import scenes as tscenes
from mcpt_torch.bvh import cluster as tcluster
from mcpt_torch.bvh import lbvh as tlbvh
from mcpt_torch.bvh import metrics as tmetrics
from mcpt_torch.bvh import treelet as ttreelet
from mcpt_torch.scene import build_scene as tbuild_scene
from mcpt_torch.types import BVH


def _random_tris(n, seed):
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-10.0, 10.0, (n, 1, 3))
    return (centre + rng.normal(0.0, 0.3, (n, 3, 3))).astype(np.float32)


def _assert_bvh_equal(got, want):
    for name in BVH._fields:
        g = getattr(got, name).cpu().numpy()
        w = np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _to_torch_bvh(jbvh):
    return BVH(*(torch.from_numpy(np.array(getattr(jbvh, f)))
                 for f in BVH._fields))


@pytest.mark.parametrize("n", [1, 2, 3, 17, 300, 5000])
def test_lbvh_equals_mcpt(n):
    verts = _random_tris(n, seed=n)
    if n == 17:  # duplicate centroids: the position tie-break decides
        verts[8:12] = verts[3]
    want = jlbvh.build_lbvh(verts)
    got = tlbvh.build_lbvh(torch.from_numpy(verts))
    _assert_bvh_equal(got, want)
    assert tlbvh.validate_bvh(got, verts)["ok"]


def test_expand_bits_and_morton_equal_mcpt():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 1 << 10, 4096).astype(np.uint32)
    np.testing.assert_array_equal(
        tlbvh.expand_bits_10(torch.from_numpy(v.astype(np.int64))).numpy(),
        np.asarray(jlbvh.expand_bits_10(v)).astype(np.int64))
    u = rng.uniform(0.0, 1.0, (4096, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tlbvh.morton30(torch.from_numpy(u)).numpy(),
        np.asarray(jlbvh.morton30(u)).astype(np.int64))


def test_clz64_is_exact_at_every_bit():
    x = torch.tensor([1 << k for k in range(63)] + [(1 << k) - 1
                                                     for k in range(2, 63)])
    want = [63 - k for k in range(63)] + [64 - k for k in range(2, 63)]
    assert tlbvh._clz64(x).tolist() == want


@pytest.mark.parametrize("n", [300, 5000])
def test_native_treelet_equals_mcpt_native(n):
    from mcpt import native

    assert native.available()
    verts = _random_tris(n, seed=7 + n)
    jbvh = jlbvh.build_lbvh(verts)
    want = jtreelet.optimize_treelets(jbvh, use_native="always")
    got = ttreelet.optimize_treelets(_to_torch_bvh(jbvh))
    _assert_bvh_equal(got, want)
    assert tmetrics.sah(got) < tmetrics.sah(_to_torch_bvh(jbvh))


def test_numpy_treelet_equals_mcpt_numpy():
    verts = _random_tris(300, seed=3)
    jbvh = jlbvh.build_lbvh(verts)
    want = jtreelet.optimize_treelets(jbvh, use_native="never")
    got = ttreelet.optimize_treelets(_to_torch_bvh(jbvh), native=False)
    _assert_bvh_equal(got, want)
    assert tlbvh.validate_bvh(got, verts)["ok"]


def _assert_plan_equal(got, want):
    for k in ("nodes", "order_p", "valid"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)


def test_cluster_plans_equal_mcpt():
    """Morton chunks, the maximal cut and the DP cut of boxfield(60)."""
    loaded, _ = jscenes.boxfield(60)
    verts = loaded.verts
    jbvh = jlbvh.build_lbvh(verts)
    tbvh = _to_torch_bvh(jbvh)
    _assert_plan_equal(tcluster.plan_clusters(verts),
                       jcluster.plan_clusters(verts))
    for dp in (False, True):
        _assert_plan_equal(tcluster.plan_clusters(verts, bvh=tbvh, dp=dp),
                           jcluster.plan_clusters(verts, bvh=jbvh, dp=dp))
    with pytest.raises(NotImplementedError, match="packed"):
        tcluster.plan_clusters(verts, bvh=tbvh, packed=True)


def _assert_scene_tables_equal(name, **kw):
    jloaded, _ = getattr(jscenes, name)(**kw)
    tloaded, _ = getattr(tscenes, name)(**kw)
    jscene, _ = jbuild_scene(jloaded)
    tscene, _ = tbuild_scene(tloaded, device="cpu")
    _assert_bvh_equal(tscene.bvh, jscene.bvh)
    for k in ("nodes", "wnodes", "tri16", "tri_map"):
        np.testing.assert_array_equal(
            getattr(tscene.clusters, k).numpy(),
            np.asarray(getattr(jscene.clusters, k)), err_msg=k)
    assert tcluster.cluster_sah(tscene.clusters) == \
        jcluster.cluster_sah(jscene.clusters)


def test_scene_tables_equal_mcpt_boxfield60():
    """build_scene end to end: LBVH, both plans, the SAH pick, Wald rows,
    the 8-wide collapse (NaN slots compare equal as arrays)."""
    _assert_scene_tables_equal("boxfield", n_boxes=60)


@pytest.mark.parametrize("name", ["boxfield", "diningroom"])
def test_scene_tables_equal_mcpt_full(name):
    """The two large configs' scenes (108,004 and 96,216 tris)."""
    _assert_scene_tables_equal(name)


def test_collapse_wide_rejects_a_too_deep_tree():
    """A binary chain over 200 clusters collapses to wide depth ≈ 200/7,
    past MAX_WIDE_DEPTH: rejected at build time, as in ``mcpt``."""
    c = 200
    nodes = np.zeros((2 * c - 1, 8), np.float32)
    nodes[:, 3:6] = 1.0
    for i in range(c - 1):
        nodes[i, 6] = float((c - 1) + i)
        nodes[i, 7] = float(i + 1) if i < c - 2 else float(2 * c - 2)
    for j in range(c):
        nodes[(c - 1) + j, 6] = nodes[(c - 1) + j, 7] = float(j)
    with pytest.raises(ValueError, match="traversal-stack bound"):
        tcluster.collapse_wide(nodes, c)


def test_treelet_gpu_bvhtype_names_its_slice():
    """``build_scene(bvhtype="treeletGPU")`` restructures the LBVH with the
    batched optimiser (``mcpt``'s ``tests/test_treelet_device.py:48-55``):
    its SAH is no worse than the LBVH's and the tree is valid."""
    loaded, _ = tscenes.boxfield(60)
    scene_g, _ = tbuild_scene(loaded, bvhtype="treeletGPU", device="cpu")
    scene_0, _ = tbuild_scene(loaded, bvhtype="hlbvh", device="cpu")
    assert tmetrics.sah(scene_g.bvh) <= tmetrics.sah(scene_0.bvh) + 1e-3
    assert tmetrics.sah(scene_g.bvh) < 0.9 * tmetrics.sah(scene_0.bvh)
    assert tlbvh.validate_bvh(scene_g.bvh, loaded.verts)["ok"]
    assert scene_g.clusters is not None


_PORT_SCENES = [("boxfield", {"n_boxes": 60}), ("boxfield", {}),
                ("diningroom", {})]


@pytest.mark.parametrize("name,kw", _PORT_SCENES)
def test_live_rows_are_the_plans_valid_rows(name, kw):
    """``live`` counts each cluster's valid rows of the plan ``build_scene``
    picks (the lower top-tree SAH of its two), which come first in their
    cluster; the count read off ``tri16`` (``live_rows``, for ``mcpt``'s
    tables) agrees, and the live rows hold every triangle once."""
    loaded, _ = getattr(tscenes, name)(**kw)
    verts = np.asarray(loaded.verts, np.float32).reshape(-1, 3, 3)
    scene, _ = tbuild_scene(loaded, device="cpu")
    cl = scene.clusters
    p_morton = tcluster.plan_clusters(verts)
    p_cut = tcluster.plan_clusters(
        verts, bvh=ttreelet.optimize_treelets(scene.bvh), dp=True)
    plan = (p_morton if tcluster.plan_sah(p_morton)
            <= tcluster.plan_sah(p_cut) else p_cut)
    np.testing.assert_array_equal(plan.nodes, cl.nodes.numpy())
    valid = plan.valid.reshape(cl.n_clusters, cl.leaf_size)
    live = cl.live.numpy()
    assert cl.live.dtype == torch.int32
    np.testing.assert_array_equal(live, valid.sum(axis=1))
    np.testing.assert_array_equal(
        valid, np.arange(cl.leaf_size)[None] < live[:, None])
    np.testing.assert_array_equal(
        tcluster.live_rows(cl.tri16.numpy(), cl.leaf_size), live)
    rows = cl.tri_map.numpy().reshape(cl.n_clusters, cl.leaf_size)
    assert sorted(rows[valid].tolist()) == list(range(verts.shape[0]))
    assert 0 < live.min() and live.max() <= cl.leaf_size


@pytest.mark.parametrize("name,kw", _PORT_SCENES)
def test_wide_depth_sizes_the_stack(name, kw):
    """The depth ``collapse_wide`` counts is the depth of the deepest
    internal node read back off ``wnodes``; the stack a walk gets,
    ``7·depth + 8``, is within ``STACK_CAP``."""
    loaded, _ = getattr(tscenes, name)(**kw)
    scene, _ = tbuild_scene(loaded, device="cpu")
    cl = scene.clusters
    assert cl.wide_depth == tcluster.wide_depth(cl.wnodes.numpy())
    assert 1 <= cl.wide_depth <= tcluster.MAX_WIDE_DEPTH
    assert tcluster.stack_entries(cl.wide_depth) == 7 * cl.wide_depth + 8
    assert tcluster.stack_entries(tcluster.MAX_WIDE_DEPTH) <= \
        tcluster.STACK_CAP


def test_wide_depth_of_a_chain():
    """A binary chain over 40 clusters: collapse_wide's count and the
    table's own depth agree, and a cyclic table is refused."""
    c = 40
    nodes = np.zeros((2 * c - 1, 8), np.float32)
    nodes[:, 3:6] = 1.0
    for i in range(c - 1):
        nodes[i, 6] = float((c - 1) + i)
        nodes[i, 7] = float(i + 1) if i < c - 2 else float(2 * c - 2)
    for j in range(c):
        nodes[(c - 1) + j, 6] = nodes[(c - 1) + j, 7] = float(j)
    wnodes, depth = tcluster._collapse_wide(nodes, c)
    np.testing.assert_array_equal(wnodes, tcluster.collapse_wide(nodes, c))
    assert depth == tcluster.wide_depth(wnodes) >= 4
    cyclic = np.zeros((1, 64), np.float32)
    cyclic[0, 3:6] = 1.0  # slot 0 is node 0 itself
    cyclic[0, 6:48] = np.nan
    with pytest.raises(ValueError, match="cycle"):
        tcluster.wide_depth(cyclic)
