"""Clustered two-level BVH: the structure the hybrid engine walks.

Port of ``mcpt/bvh/cluster.py`` (host numpy, like ``mcpt``'s):

- triangles are grouped into **clusters** of at most ``LEAF_SIZE`` (32):
  fixed Morton chunks, or a cut of the per-triangle LBVH into subtrees
  (maximal, or SAH-optimal by dynamic programming);
- a binary top tree over the cluster boxes (``nodes``), collapsed into 8-wide
  nodes (``wnodes``) with far-to-near child orders per direction octant;
- the cluster triangle table ``tri16`` in the megakernel's row layout (Wald
  transform, normal, material id), padded per cluster with never-hit rows.

The tables equal ``mcpt``'s bit for bit.  Beside them the port keeps two
things of its own, for the walks: each cluster's count of real rows
(``live``: the padding rows sit last in their cluster, and a walk stops
there) and the wide tree's depth (``wide_depth``: a walk's stack needs at
most ``stack_entries(wide_depth)``).  ``packed=True`` (``_cut_merged``)
was measured and not adopted by ``mcpt``, and is not ported; nor are the
knobs no caller of ``mcpt``'s sets (``leaf_size``, ``optimize_top``, the DP
cut's ratio): they are the constants below.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcpt_torch.bvh import lbvh as lbvh_mod
from mcpt_torch.bvh import treelet as treelet_mod
from mcpt_torch.bvh.metrics import C_INN, C_TRI

LEAF_SIZE = 32  # triangle rows per cluster

# Traversal-stack capacity shared by this builder and the walks
# (``kernels/cluster_megakernel.walk_reference``, ``csrc/cluster_walk.cuh``).
# A walk pops one entry and pushes ≤ 8 children per step, nearest last, so a
# stack holds at most 7 not-yet-taken siblings per ancestor level plus the 8
# of the current push: ``sp ≤ 7·d + 8`` at wide depth d.  ``collapse_wide``
# rejects any tree deep enough to break that bound; the walks still check
# every push and raise on an overflow.
STACK_CAP = 128
MAX_WIDE_DEPTH = (STACK_CAP - 8) // 7  # deepest legal internal wide node
MCPT_FIELDS = ("nodes", "wnodes", "tri16", "tri_map")  # mcpt's ClusterBVH


def stack_entries(wide_depth: int) -> int:
    """Stack entries a walk needs at most on a wide tree whose deepest
    internal node is at ``wide_depth`` (root 0): ``7·depth + 8``."""
    return 7 * wide_depth + 8


class ClusterBVH(NamedTuple):
    """The hybrid engine's tables (tensors on one device).

    ``nodes``: the binary top tree over C clusters (2C-1 nodes, the ``BVH``
    layout contract), one f32 row per node: [bbmin xyz, bbmax xyz, left,
    right] (child ids as f32, exact to 2^24).

    ``wnodes``: the 8-wide collapse, 64 f32 per row:

    - ``[6k : 6k+6]`` child k's AABB (empty slots: NaN, never hit);
    - ``[48 + k]`` child k's stack encoding: wide-node index if internal,
      ``Nw + cluster_id`` if a leaf cluster, 0 if empty (never pushed);
    - ``[56 + o]`` the child slots far-to-near for direction octant ``o``
      (bit 0: x > 0, bit 1: y > 0, bit 2: z > 0), 3-bit digits, slot j at
      bits 3j.
    """

    nodes: torch.Tensor  # (2C-1, 8) f32
    wnodes: torch.Tensor  # (Nw, 64) f32
    tri16: torch.Tensor  # (C·T, 16) f32 — megakernel row layout, cluster order
    tri_map: torch.Tensor  # (C·T,) int32 — row → original triangle id (pad: 0)
    # the port's own, beside mcpt's tables (``MCPT_FIELDS``)
    live: torch.Tensor  # (C,) int32 — real rows per cluster, first in it
    wide_depth: int  # depth of the deepest internal wide node (root 0)

    @property
    def n_clusters(self) -> int:
        return (self.nodes.shape[0] + 1) // 2

    @property
    def leaf_size(self) -> int:
        return self.tri16.shape[0] // self.n_clusters


class ClusterPlan(NamedTuple):
    """Topology-only plan: enough to score a clustering by top-tree SAH
    (``plan_sah``) without the Wald-table build."""

    nodes: np.ndarray  # (2C-1, 8) f32 binary top tree
    order_p: np.ndarray  # (C·T,) int32 cluster-ordered triangle ids (padded)
    valid: np.ndarray  # (C·T,) bool — False on padding rows


def plan_clusters(verts: np.ndarray, bvh=None, packed: bool = False,
                  dp: bool = False) -> ClusterPlan:
    """Topology half of ``build_clusters``.  Without ``bvh``: fixed Morton
    chunks under a treelet-optimised top tree.  With it: the maximal
    ≤ ``LEAF_SIZE`` subtree cut of ``bvh``, or with ``dp`` the SAH-optimal
    cut (``_cut_tree_dp``)."""
    if packed:
        raise NotImplementedError(
            "plan_clusters(packed=True) (the merged cut) was measured and not "
            "adopted by mcpt; it is not ported (ROADMAP 'Leave behind')")
    v = np.asarray(verts, np.float32).reshape(-1, 3, 3)
    n = v.shape[0]
    t = LEAF_SIZE
    tri_min = v.min(axis=1)
    tri_max = v.max(axis=1)
    if bvh is not None and n > 1:
        if dp:
            nodes, order_p, valid = _cut_tree_dp(bvh, n, t)
        else:
            nodes, order_p, valid = _cut_tree(bvh, n, t)
    else:
        nodes, order_p, valid = _morton_chunks(tri_min, tri_max, n, t)
    return ClusterPlan(nodes=nodes, order_p=order_p, valid=valid)


def plan_sah(plan: ClusterPlan) -> float:
    """Top-tree SAH of a plan (``cluster_sah``'s definition)."""
    return _nodes_sah(plan.nodes)


def build_clusters(verts: np.ndarray, normals: np.ndarray, mat_id: np.ndarray,
                   plan: ClusterPlan, device="cpu") -> ClusterBVH:
    """Triangle soup + a plan → ClusterBVH on ``device``: the Wald rows in
    cluster order and the 8-wide collapse.  Padding rows carry the never-hit
    Wald transform (A = 0, b = (0, 0, 1) ⇒ d'_w = 0 ⇒ t = -inf); ``live``
    counts each cluster's ``valid`` rows, which come first in it."""
    from mcpt_torch.scene import build_wald

    v = np.asarray(verts, np.float32).reshape(-1, 3, 3)
    t = LEAF_SIZE
    nodes, order_p, valid = plan.nodes, plan.order_p, plan.valid
    c = order_p.shape[0] // t

    wald = build_wald(v[order_p], "cpu")
    a = np.transpose(wald.w.numpy(), (1, 2, 0))  # (C·T, 3, 3) = A
    tri16 = np.zeros((c * t, 16), np.float32)
    tri16[:, 0:9] = a.reshape(c * t, 9)
    tri16[:, 9:12] = wald.b.numpy()
    tri16[:, 12:15] = np.asarray(normals, np.float32).reshape(-1, 3)[order_p]
    tri16[:, 15] = np.clip(np.asarray(mat_id).reshape(-1), 0, None)[
        order_p].astype(np.float32)
    if not valid.all():
        tri16[~valid, 0:9] = 0.0
        tri16[~valid, 9:12] = np.array([0.0, 0.0, 1.0], np.float32)

    per = valid.reshape(c, t)
    live = per.sum(axis=1).astype(np.int32)
    if not (per == (np.arange(t) < live[:, None])).all():
        raise AssertionError("a padding row precedes a real row in a cluster")
    wnodes, depth = _collapse_wide(nodes, c)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return ClusterBVH(nodes=dev(nodes), wnodes=dev(wnodes), tri16=dev(tri16),
                      tri_map=dev(np.where(valid, order_p, 0).astype(np.int32)),
                      live=dev(live), wide_depth=depth)


def live_rows(tri16: np.ndarray, leaf_size: int) -> np.ndarray:
    """(C,) int32 rows per cluster up to its last row that is not the
    never-hit padding row: the ``live`` of tables that come without their
    plan (``mcpt``'s, through ``convert``).  It equals the plan's count but
    where a degenerate triangle, whose row is the padding row, ends a
    cluster; such a row never hits, so the walks' answers are the same."""
    rows = np.asarray(tri16, np.float32).reshape(-1, leaf_size, 16)
    pad = ((rows[:, :, 0:9] == 0.0).all(axis=2)
           & (rows[:, :, 9:12] == np.array([0.0, 0.0, 1.0], np.float32))
           .all(axis=2))
    real = ~pad
    last = leaf_size - np.argmax(real[:, ::-1], axis=1)
    return np.where(real.any(axis=1), last, 0).astype(np.int32)


def wide_depth(wnodes: np.ndarray) -> int:
    """Depth of the deepest internal node of an 8-wide table (root 0), read
    from its child codes: ``_collapse_wide``'s own count, for tables that
    come without it."""
    w = np.asarray(wnodes, np.float32)
    nw = w.shape[0]
    depth, frontier = 0, [0]
    while True:
        codes = w[frontier, 48:56][~np.isnan(w[frontier, 0:48:6])]
        frontier = sorted({int(x) for x in codes if x < nw})
        if not frontier:
            return depth
        depth += 1
        if depth >= nw:
            raise ValueError("8-wide table has a cycle")


def _bvh_numpy(bvh):
    return (bvh.left.cpu().numpy(), bvh.right.cpu().numpy(),
            bvh.bbmin.cpu().numpy(), bvh.bbmax.cpu().numpy())


def _morton_chunks(tri_min, tri_max, n, t):
    """Fixed Morton chunks of ``t`` triangles + a Karras top tree over them,
    treelet-optimised (the top tree is small: the C++ optimiser takes ms)."""
    centroid = 0.5 * (tri_min + tri_max)
    cmin = centroid.min(axis=0)
    extent = np.maximum(centroid.max(axis=0) - cmin, 1e-20)
    codes = lbvh_mod.morton30(
        torch.from_numpy(np.ascontiguousarray((centroid - cmin) / extent)))
    order = np.argsort(codes.numpy(), kind="stable").astype(np.int32)
    return _top_over_chunks(order, tri_min, tri_max, n, t)


def _subtree_counts(bvh, n):
    """Per-node subtree triangle counts of a (possibly restructured) LBVH."""
    left, right, _, _ = _bvh_numpy(bvh)
    leaf_base = n - 1
    counts = np.zeros(2 * n - 1, np.int64)
    stack = [(0, False)]
    while stack:
        v, expanded = stack.pop()
        if v >= leaf_base:
            counts[v] = 1
            continue
        if expanded:
            counts[v] = counts[left[v]] + counts[right[v]]
        else:
            stack.append((v, True))
            stack.append((left[v], False))
            stack.append((right[v], False))
    return counts


def _top_over_chunks(order, tri_min, tri_max, n, t):
    """Chunk a triangle order into ``t``-sized clusters + a Karras top tree
    over the chunk AABBs."""
    c = (n + t - 1) // t
    pad = c * t - n
    order_p = np.concatenate([order, np.zeros(pad, np.int32)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])

    # cluster AABBs over real members only
    cl_min = np.where(valid[:, None], tri_min[order_p], np.inf).reshape(c, t, 3)
    cl_max = np.where(valid[:, None], tri_max[order_p], -np.inf).reshape(c, t, 3)
    top = lbvh_mod.build_lbvh_boxes(
        torch.from_numpy(np.ascontiguousarray(cl_min.min(axis=1), np.float32)),
        torch.from_numpy(np.ascontiguousarray(cl_max.max(axis=1), np.float32)))
    if c > 3:
        top = treelet_mod.optimize_treelets(top)
    nodes = np.zeros((top.n_nodes, 8), np.float32)
    nodes[:, 0:3] = top.bbmin.numpy()
    nodes[:, 3:6] = top.bbmax.numpy()
    nodes[:, 6] = top.left.numpy().astype(np.float32)
    nodes[:, 7] = top.right.numpy().astype(np.float32)
    return nodes, order_p, valid


def _node_areas(bvh) -> np.ndarray:
    _, _, bbmin, bbmax = _bvh_numpy(bvh)
    d = np.maximum(bbmax - bbmin, 0.0)
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]


# C_visit/C_node ratio for the DP cut: what a cluster visit (a full 32-row
# Wald test) costs relative to one binary top-tree node's share of the walk.
# With the plain SAH constants (1 : 1.2) the DP reduces to the maximal cut,
# so the ratio must be > 1 for the DP to differ (mcpt's calibration).
DEFAULT_DP_RATIO = 3.0


def _cut_tree_dp(bvh, n, t):
    """Cost-optimal cut of the per-triangle BVH into ≤ t-triangle clusters,
    bottom-up over

        cost[v] = min( C_LEAF·A(v)                       [if count(v) ≤ t]
                     , C_INN·A(v) + cost[l] + cost[r] )  [if internal]

    with ``C_LEAF = DEFAULT_DP_RATIO · C_INN``; the cut is the argmin
    frontier."""
    c_leaf = DEFAULT_DP_RATIO * C_INN
    left, right, _, _ = _bvh_numpy(bvh)
    leaf_base = n - 1
    counts = _subtree_counts(bvh, n)
    area = _node_areas(bvh)

    cost = np.zeros(2 * n - 1, np.float64)
    cut_here = np.zeros(2 * n - 1, bool)
    cut_here[leaf_base:] = True
    cost[leaf_base:] = c_leaf * area[leaf_base:]
    stack = [(0, False)]  # postorder over internals
    while stack:
        v, expanded = stack.pop()
        if v >= leaf_base:
            continue
        if not expanded:
            stack.append((v, True))
            stack.append((left[v], False))
            stack.append((right[v], False))
            continue
        c_split = C_INN * area[v] + cost[left[v]] + cost[right[v]]
        c_cut = c_leaf * area[v] if counts[v] <= t else np.inf
        if c_cut <= c_split:
            cost[v] = c_cut
            cut_here[v] = True
        else:
            cost[v] = c_split
    return _materialize_cut(bvh, n, t, lambda v: cut_here[v])


def _cut_tree(bvh, n, t):
    """Cut the per-triangle LBVH at maximal ≤ t-triangle subtrees."""
    counts = _subtree_counts(bvh, n)
    return _materialize_cut(bvh, n, t, lambda v: counts[v] <= t)


def _materialize_cut(bvh, n, t, cut_pred):
    """Collect the cut frontier (preorder; ``cut_pred(v)`` decides) and emit
    (nodes, order_p, valid): the contracted top tree in the standard layout
    plus each cluster's triangles."""
    left, right, bbmin, bbmax = _bvh_numpy(bvh)
    leaf_base = n - 1

    cut = []  # binary node id per cluster
    inner = []  # contracted internal nodes, preorder (root first)
    stack = [0]
    while stack:
        v = stack.pop()
        if cut_pred(v):
            cut.append(v)
        else:
            inner.append(v)
            stack.append(right[v])
            stack.append(left[v])
    c = len(cut)
    if len(inner) != c - 1:
        raise AssertionError(f"cut is not a tree: {len(inner)} inner nodes "
                             f"for {c} clusters")

    order_p = np.zeros(c * t, np.int32)
    valid = np.zeros(c * t, bool)
    for ci, root in enumerate(cut):
        tris = []
        st = [root]
        while st:
            v = st.pop()
            if v >= leaf_base or n == 1:
                tris.append(left[v])
            else:
                st.append(right[v])
                st.append(left[v])
        order_p[ci * t: ci * t + len(tris)] = tris
        valid[ci * t: ci * t + len(tris)] = True

    new_id = {v: i for i, v in enumerate(inner)}
    for ci, v in enumerate(cut):
        new_id[v] = (c - 1) + ci
    nodes = np.zeros((2 * c - 1, 8), np.float32)
    for v, i in new_id.items():
        nodes[i, 0:3] = bbmin[v]
        nodes[i, 3:6] = bbmax[v]
        if i < c - 1:
            nodes[i, 6] = float(new_id[left[v]])
            nodes[i, 7] = float(new_id[right[v]])
        else:
            nodes[i, 6] = nodes[i, 7] = float(i - (c - 1))
    return nodes, order_p, valid


_WIDE = 8
_BIG_BOX = np.float32(3.0e37)
_WIDE_LEAF_BIAS = 1 << 23  # temporary leaf tag during collapse (≥ any Nw)


def collapse_wide(nodes: np.ndarray, n_clusters: int) -> np.ndarray:
    """Collapse the binary top tree into 8-wide nodes (the standard BVH8
    collapse: each wide node grows from its binary root by splitting its
    largest-area internal member until 8 members), with the 8 octant orders
    per node (see ``ClusterBVH``).  Raises ``ValueError`` when the wide tree
    is too deep for ``STACK_CAP``."""
    return _collapse_wide(nodes, n_clusters)[0]


def _collapse_wide(nodes: np.ndarray, n_clusters: int):
    """``collapse_wide`` → (wnodes, depth of its deepest internal node)."""
    c = n_clusters
    leaf_base = c - 1
    bbmin = nodes[:, 0:3]
    bbmax = nodes[:, 3:6]
    left = nodes[:, 6].astype(np.int32)
    right = nodes[:, 7].astype(np.int32)

    def area(i):
        d = np.maximum(bbmax[i] - bbmin[i], 0.0)
        return d[0] * d[1] + d[0] * d[2] + d[1] * d[2]

    def is_bin_leaf(i):
        return c == 1 or i >= leaf_base

    rows = []
    queue = [0]  # binary roots of pending wide nodes (BFS)
    wide_index = {0: 0}  # binary root id → wide node index
    depth_of = {0: 0}  # wide node index → depth (root = 0)
    max_depth = 0
    while queue:
        root = queue.pop(0)
        members = [root]
        while len(members) < _WIDE:
            inner = [m for m in members if not is_bin_leaf(m)]
            if not inner:
                break
            grow = max(inner, key=area)
            members.remove(grow)
            members.extend([left[grow], right[grow]])
        row = np.zeros(64, np.float32)
        centers = np.zeros((_WIDE, 3), np.float32)
        for k in range(_WIDE):
            if k < len(members):
                m = members[k]
                row[6 * k: 6 * k + 3] = bbmin[m]
                row[6 * k + 3: 6 * k + 6] = bbmax[m]
                centers[k] = 0.5 * (bbmin[m] + bbmax[m])
                if is_bin_leaf(m):
                    cluster = left[m] if c > 1 else 0
                    row[48 + k] = float(_WIDE_LEAF_BIAS + cluster)
                else:
                    if m not in wide_index:
                        wide_index[m] = len(wide_index)
                        depth_of[wide_index[m]] = (
                            depth_of[wide_index[root]] + 1)
                        max_depth = max(max_depth, depth_of[wide_index[m]])
                        queue.append(m)
                    row[48 + k] = float(wide_index[m])
            else:
                # NaN box: every slab comparison is false, so an empty slot
                # is never hit (an inverted ±BIG box would be: the slab
                # test's per-axis min/max erases box orientation)
                row[6 * k: 6 * k + 6] = np.nan
                centers[k] = _BIG_BOX  # sorts to the far end, never pushed
        for o in range(8):  # children far-to-near along each octant
            d = np.array([1.0 if o & 1 else -1.0, 1.0 if o & 2 else -1.0,
                          1.0 if o & 4 else -1.0], np.float32)
            order = np.argsort(-(centers @ d), kind="stable")  # far first
            code = 0
            for j, k in enumerate(order):
                code |= int(k) << (3 * j)
            row[56 + o] = float(code)  # < 2^24: exact in f32
        rows.append((wide_index[root], row))
    if max_depth > MAX_WIDE_DEPTH:
        raise ValueError(
            f"8-wide top tree depth {max_depth} exceeds the traversal-stack "
            f"bound ({MAX_WIDE_DEPTH}: worst-case stack 7·depth + 8 > "
            f"STACK_CAP={STACK_CAP}).  The top tree is pathologically "
            f"unbalanced ({n_clusters} clusters need depth "
            f"~log8 = {max(1, int(np.ceil(np.log2(max(n_clusters, 2)) / 3)))}"
            f"); rebuild with a different clustering or raise STACK_CAP.")
    out = np.zeros((len(rows), 64), np.float32)
    for idx, row in rows:
        out[idx] = row
    # leaf encodings need Nw, which is only known now: rebase the bias
    nw = out.shape[0]
    refs = out[:, 48:56]
    out[:, 48:56] = np.where(refs >= _WIDE_LEAF_BIAS,
                             refs - _WIDE_LEAF_BIAS + nw, refs)
    return out, max_depth


def cluster_sah(c: ClusterBVH) -> float:
    """SAH of the top tree; comparable across builds of one scene at one
    leaf size (lower picked the measured-faster hierarchy in ``mcpt``)."""
    return _nodes_sah(c.nodes.cpu().numpy())


def _nodes_sah(n: np.ndarray) -> float:
    d = np.maximum(n[:, 3:6] - n[:, 0:3], 0.0)
    area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    n_internal = n.shape[0] // 2
    total = C_INN * area[:n_internal].sum() + C_TRI * area[n_internal:].sum()
    return float(total / max(area[0], 1e-30))
