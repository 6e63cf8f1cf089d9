"""BVH construction-quality metrics: SAH, EPO, LCV.

The port of ``mcpt/bvh/metrics.py`` (the reference's research harness,
``bvhtest.cpp`` + ``kernels/EPO.cl``), with the same definitions, so the
numbers compare:

- **SAH** (``bvhtest.cpp:104-115``): ``(Σ_internal C_INN·A(n) + Σ_leaf
  C_TRI·A(n)) / A(root)``, C_INN = 1.2, C_TRI = 1 (``auxiliary.h:9-11``).
- **EPO**, expected projected overlap (Aila et al. 2013; ``bvhtest.cpp:
  221-284``): for every leaf triangle, the area of the triangle clipped to
  every non-ancestor node's box, weighted C_INN or C_TRI, over the total
  triangle area.  By default the host C++ walk (``csrc/host/epo.cpp``, the
  port's copy of ``mcpt``'s native one); ``use_native="never"`` runs a
  batched stack walk and batched Sutherland–Hodgman clips in PyTorch on a
  device.
- **LCV**, leaf-count variation (``bvhtest.cpp:324-444``): the standard
  deviation of the number of leaf boxes hit along primary camera rays
  through pixel centres, with the reference's aspect-free ray generator
  (``bvhtest.cpp:413-424``).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

C_INN = 1.2  # internal-node traversal cost (auxiliary.h:9-11)
C_TRI = 1.0  # triangle-intersection cost


def _area(bbmin, bbmax):
    d = np.maximum(bbmax - bbmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def sah(bvh) -> float:
    """``(Σ_internal C_INN·A(n) + Σ_leaf C_TRI·A(n)) / A(root)``
    (``bvhtest.cpp:104-115``)."""
    bbmin = bvh.bbmin.cpu().numpy()
    bbmax = bvh.bbmax.cpu().numpy()
    n_internal = bbmin.shape[0] // 2  # == N-1 for 2N-1 nodes
    areas = _area(bbmin, bbmax)
    total = C_INN * areas[:n_internal].sum() + C_TRI * areas[n_internal:].sum()
    return float(total / max(areas[0], 1e-30))


def _verts64(verts) -> np.ndarray:
    if isinstance(verts, torch.Tensor):
        verts = verts.cpu().numpy()
    return np.asarray(verts, np.float64).reshape(-1, 3, 3)


def tri_area(verts) -> np.ndarray:
    """Each triangle's area, float64."""
    v = _verts64(verts)
    return 0.5 * np.linalg.norm(
        np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)


# ---------------------------------------------------------------------------
# EPO
# ---------------------------------------------------------------------------


def _clip_areas(tris: torch.Tensor, bmin: torch.Tensor,
                bmax: torch.Tensor) -> torch.Tensor:
    """Area of each triangle clipped to its box: tris (P, 3, 3), bmin/bmax
    (P, 3) → (P,), in the inputs' dtype and on their device (``mcpt``'s
    ``_clip_areas_jnp``, :60-135).  Sutherland–Hodgman over the six box
    planes in the native walk's order and with its crossing parameter; the
    polygon buffer grows one slot a plane (3 → 9), and slots past a
    polygon's end repeat its first vertex, which adds nothing to the
    area."""
    verts = tris
    for axis in range(3):
        for side in range(2):  # 0: keep ≥ bmin, 1: keep ≤ bmax
            cap = verts.shape[1]
            ocap = min(cap + 1, 9)
            bound = (bmin if side == 0 else bmax)[:, axis]
            sgn = 1.0 if side == 0 else -1.0
            da = sgn * (verts[:, :, axis] - bound[:, None])  # signed distance
            # ring successor: slot s+1, cyclically (the trailing repeats keep
            # it exact: the successor of the last slot is ring point 0)
            v_next = torch.roll(verts, -1, dims=1)
            db = torch.roll(da, -1, dims=1)
            keep = da >= 0.0  # the edge emits its own vertex...
            crossing = keep ^ (db >= 0.0)  # ...and the plane crossing
            t = da / torch.where(da == db, torch.ones_like(da), da - db)
            cross_pt = verts + t[..., None] * (v_next - verts)
            emit = keep.long() + crossing.long()
            ends = torch.cumsum(emit, dim=1)
            starts = ends - emit
            total = ends[:, -1]
            # output slot s ← edge e(s) = #{j : ends[j] ≤ s}
            s_vals = torch.arange(ocap, device=verts.device)
            e = (ends[:, None, :] <= s_vals[None, :, None]).sum(2)
            e = e.clamp(max=cap - 1)
            e3 = e[..., None].expand(-1, -1, 3)
            start_e = torch.gather(starts, 1, e)
            keep_e = torch.gather(keep, 1, e)
            crossing_e = torch.gather(crossing, 1, e)
            is_vertex = keep_e & ((s_vals[None, :] == start_e) | ~crossing_e)
            pick = torch.where(is_vertex[..., None],
                               torch.gather(verts, 1, e3),
                               torch.gather(cross_pt, 1, e3))
            # slots past the end repeat the first output point
            out_valid = s_vals[None, :] < total[:, None]
            verts = torch.where(out_valid[..., None], pick, pick[:, :1])
    # the planar polygon's area: half the norm of its fan's cross products
    v0 = verts[:, :1]
    cr = torch.cross(verts - v0, torch.roll(verts, -1, dims=1) - v0, dim=-1)
    tot = cr.sum(1)
    return 0.5 * torch.sqrt((tot * tot).sum(-1))


def _epo_host(bvh, v: np.ndarray, n_threads: int | None = None) -> float:
    from mcpt_torch.kernels import _build

    lib = _build.load_host()
    verts = np.ascontiguousarray(v, np.float32).reshape(-1, 9)
    bbmin, bbmax, left, right = (
        np.ascontiguousarray(t.cpu().numpy(), dtype)
        for t, dtype in zip(bvh[:4], (np.float32, np.float32, np.int32,
                                      np.int32)))
    if n_threads is None:  # mcpt.native.epo_native's default
        n_threads = min(16, os.cpu_count() or 1)
    return float(lib.mcpt_epo(verts.ctypes.data, verts.shape[0],
                              bbmin.ctypes.data, bbmax.ctypes.data,
                              left.ctypes.data, right.ctypes.data,
                              C_INN, C_TRI, int(n_threads)))


def epo(bvh, verts, chunk: int = 2048, use_native: str = "auto",
        device="cpu") -> float:
    """Expected projected overlap (reference semantics,
    ``bvhtest.cpp:221-284``; ``mcpt``'s ``epo``, :145-344).

    ``use_native``: ``"always"``, or ``"auto"`` on a CPU ``device``, runs the
    host C++ walk (parallel over leaves; built at first use, and a failed
    build raises); ``"never"``, or ``"auto"`` elsewhere, runs the PyTorch
    walk on ``device``:

    1. a batched walk: ``chunk`` lanes, one leaf triangle each, pop one node
       a step in lock-step and are refilled from a queue that starts with
       the largest triangles (their walks are the longest).  A lane
       descends on box overlap, a superset of the reference's positive-clip
       rule whose extra subtrees clip to zero, and prunes boxes that lie
       strictly on one side of the triangle's plane.  Ancestors are an
       interval test over subtree leaf ranges.  The tests run in float32,
       as in the native walk.  A node box that contains the triangle's box
       adds the triangle's whole area; every other overlapping pair goes to
    2. the clip batches: Sutherland–Hodgman in float64 on ``device`` (the
       native walk's precision; the H100 has float64 units).
    """
    v = _verts64(verts)
    if use_native not in ("auto", "always", "never"):
        raise ValueError(f"use_native must be auto, always or never, not "
                         f"{use_native!r}")
    dev = torch.device(device)
    if use_native == "always" or (use_native == "auto" and dev.type == "cpu"):
        return _epo_host(bvh, v)
    from mcpt_torch.bvh.lbvh import one_thread

    with one_thread(dev):
        return _epo_walk(bvh, v, chunk, dev)


def _subtree_ranges(left: np.ndarray, right: np.ndarray, leaf_base: int):
    """Each node's [lo, hi] range of leaf positions (Karras internal nodes
    cover contiguous ranges of the sorted leaves)."""
    n_nodes = left.shape[0]
    lo = np.zeros(n_nodes, np.int64)
    hi = np.zeros(n_nodes, np.int64)
    lo[leaf_base:] = hi[leaf_base:] = np.arange(n_nodes - leaf_base)
    internal = np.arange(leaf_base)
    for _ in range(n_nodes):  # bottom-up, until nothing changes
        new_lo = np.minimum(lo[left[internal]], lo[right[internal]])
        new_hi = np.maximum(hi[left[internal]], hi[right[internal]])
        if (new_lo == lo[:leaf_base]).all() and \
                (new_hi == hi[:leaf_base]).all():
            break
        lo[:leaf_base] = new_lo
        hi[:leaf_base] = new_hi
    return lo, hi


def _epo_walk(bvh, v: np.ndarray, chunk: int, dev: torch.device) -> float:
    left = bvh.left.cpu().numpy().astype(np.int64)
    right = bvh.right.cpu().numpy().astype(np.int64)
    n = (left.shape[0] + 1) // 2
    if n == 1:
        return 0.0
    leaf_base = n - 1
    lo, hi = _subtree_ranges(left, right, leaf_base)
    # a DFS stack never holds more than the tree's depth + 1 nodes
    depth, frontier = 0, np.array([0], np.int64)
    while (frontier := frontier[frontier < leaf_base]).size:
        frontier = np.concatenate([left[frontier], right[frontier]])
        depth += 1
    cap = depth + 2

    tri_of_leaf = left[leaf_base:]
    tmin, tmax = v.min(axis=1), v.max(axis=1)
    ext = (tmax - tmin)[tri_of_leaf]
    queue = np.argsort(-(ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                         + ext[:, 2] * ext[:, 0]), kind="stable")
    area64 = tri_area(v)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    f32, i64 = torch.float32, torch.int64
    bbmin = bvh.bbmin.to(dev, f32)
    bbmax = bvh.bbmax.to(dev, f32)
    left_t, right_t = put(left, i64), put(right, i64)
    lo_t, hi_t = put(lo, i64), put(hi, i64)
    leaf_tri = put(tri_of_leaf, i64)
    gmin_all, gmax_all = put(tmin, f32), put(tmax, f32)
    nrm_all = put(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), f32)
    nv0_all = put(v[:, 0], f32)
    area_all = put(area64, torch.float64)
    queue_t = put(queue, i64)
    weight = put(np.where(np.arange(left.shape[0]) >= leaf_base, C_TRI,
                          C_INN), torch.float64)  # C_INN or C_TRI by node

    pos = torch.zeros(0, dtype=i64, device=dev)  # the lanes' leaf positions
    stack = torch.zeros((0, cap), dtype=i64, device=dev)
    sp = torch.zeros(0, dtype=i64, device=dev)
    next_leaf = 0
    contained = torch.zeros((), dtype=torch.float64, device=dev)
    pair_nodes, pair_tris = [], []
    while True:
        take = min(chunk - pos.shape[0], n - next_leaf)
        if take > 0:  # refill: new lanes start with the root on the stack
            pos = torch.cat([pos, queue_t[next_leaf:next_leaf + take]])
            stack = torch.cat([stack, torch.zeros((take, cap), dtype=i64,
                                                  device=dev)])
            sp = torch.cat([sp, torch.ones(take, dtype=i64, device=dev)])
            next_leaf += take
        if pos.shape[0] == 0:
            break
        lanes = torch.arange(pos.shape[0], device=dev)
        sp = sp - 1
        node = stack[lanes, sp]
        tri = leaf_tri[pos]
        is_anc = (lo_t[node] <= pos) & (pos <= hi_t[node])
        bmn, bmx = bbmin[node], bbmax[node]
        gmin, gmax = gmin_all[tri], gmax_all[tri]
        nrm = nrm_all[tri]
        overlap = ((gmin <= bmx) & (gmax >= bmn)).all(1)
        # a box strictly on one side of the triangle's plane clips to zero,
        # and so does its subtree.  sd = n·(c − v0), translated before the
        # product (n·c − n·v0 cancels in float32 far from the origin); the
        # small margin absorbs float32 rounding
        sd = (nrm * (0.5 * (bmn + bmx) - nv0_all[tri])).sum(1)
        rd = 0.5 * (nrm.abs() * (bmx - bmn)).sum(1)
        overlap &= sd.abs() <= rd + 1e-4 * (rd + sd.abs())
        need = overlap & ~is_anc
        # a box that contains the triangle's box clips the whole triangle
        full = need & ((gmin >= bmn) & (gmax <= bmx)).all(1)
        contained += torch.where(full, weight[node] * area_all[tri],
                                 0.0).sum()
        part = need & ~full
        pair_nodes.append(node[part])
        pair_tris.append(tri[part])
        # descend: ancestors always, others on overlap; left pops first
        descend = (node < leaf_base) & (is_anc | overlap)
        for child in (right_t, left_t):
            slot = sp.clamp(max=cap - 1)
            stack[lanes, slot] = torch.where(descend, child[node],
                                             stack[lanes, slot])
            sp = sp + descend.long()
        live = sp > 0
        if not bool(live.all()):
            pos, stack, sp = pos[live], stack[live], sp[live]

    total = contained
    nodes = torch.cat(pair_nodes)
    tris = torch.cat(pair_tris)
    v64 = put(v, torch.float64)
    bbmin64 = bvh.bbmin.to(dev, torch.float64)
    bbmax64 = bvh.bbmax.to(dev, torch.float64)
    batch = 1 << 16
    for i in range(0, nodes.shape[0], batch):
        nd, tr = nodes[i:i + batch], tris[i:i + batch]
        total = total + (_clip_areas(v64[tr], bbmin64[nd], bbmax64[nd])
                         * weight[nd]).sum()
    return float(total) / max(float(area64.sum()), 1e-30)


# ---------------------------------------------------------------------------
# LCV
# ---------------------------------------------------------------------------


def lcv(bvh, camera, width: int, height: int) -> float:
    """σ of leaf-box hit counts along primary rays (``bvhtest.cpp:324-444``;
    ``mcpt``'s ``lcv``, :456-524), walked on the camera's device.

    Rays use the reference's LCV generator: pixel centres, no aspect scaling
    (``bvhtest.cpp:413-424``, unlike the render camera).  Every ray walks
    its own 64-entry stack in lock-step (rays that have ended leave the
    batch every 16 steps); like ``mcpt``'s, a push past the stack's end
    overwrites its last entry.  Divisions are by tensors, so
    CPU and CUDA round them alike."""
    from mcpt_torch.bvh.lbvh import one_thread

    dev = camera.position.device
    with one_thread(dev):
        counts = _leaf_counts(bvh, camera, width, height, dev)
    c = counts.cpu().numpy().astype(np.float64)
    return float(math.sqrt(max((c * c).mean() - c.mean() ** 2, 0.0)))


def _leaf_counts(bvh, camera, width, height, dev) -> torch.Tensor:
    f32 = torch.float32
    bbmin = bvh.bbmin.to(dev, f32)
    bbmax = bvh.bbmax.to(dev, f32)
    left = bvh.left.to(dev, torch.int64)
    right = bvh.right.to(dev, torch.int64)
    leaf_base = bvh.n_tris - 1

    def scalar(x):
        return torch.tensor(float(x), dtype=f32, device=dev)

    idx = torch.arange(width * height, device=dev)
    i = (idx % width).to(f32)
    j = torch.div(idx, width, rounding_mode="floor").to(f32)
    t1 = (i + 0.5) / scalar(width) - 0.5
    t2 = (j + 0.5) / scalar(height) - 0.5
    dist = scalar(0.5) / camera.half_height  # 0.5 / tan(fov/2)
    d = (dist * camera.forward[None] + t1[:, None] * camera.right[None]
         + t2[:, None] * camera.up[None])
    o = camera.position[None]
    tiny = 1e-30
    inv = torch.ones_like(d) / torch.where(
        d.abs() < tiny, torch.where(d < 0, -tiny, tiny), d)
    r = d.shape[0]

    def slab_hit(node, inv):
        t0 = (bbmin[node] - o) * inv
        t1_ = (bbmax[node] - o) * inv
        tn = torch.minimum(t0, t1_).amax(-1)
        tf = torch.maximum(t0, t1_).amin(-1)
        return tf >= torch.clamp(tn, min=0.001)

    if leaf_base == 0:  # one triangle: the root is its leaf
        return slab_hit(torch.zeros(r, dtype=torch.int64, device=dev),
                        inv).int()
    counts = torch.zeros(r, dtype=torch.int32, device=dev)
    # the live rays: their ids, stacks, stack pointers, counts and 1/d
    ids = torch.arange(r, device=dev)
    stack = torch.zeros((r, 64), dtype=torch.int64, device=dev)
    sp = torch.ones(r, dtype=torch.int64, device=dev)
    count = torch.zeros(r, dtype=torch.int32, device=dev)
    step = 0
    while True:
        # every 16 steps, a read-back: ended rays hand in their counts and
        # leave (until then they pop nothing and change nothing)
        if step % 16 == 0:
            live = sp > 0
            if not bool(live.all()):
                counts[ids[~live]] = count[~live]
                ids, stack, sp, count, inv = (
                    x[live] for x in (ids, stack, sp, count, inv))
            if ids.shape[0] == 0:
                return counts
        step += 1
        lanes = torch.arange(ids.shape[0], device=dev)
        live = sp > 0
        node = torch.where(live, stack[lanes, (sp - 1).clamp(0, 63)], 0)
        sp = torch.where(live, sp - 1, sp)
        hit = slab_hit(node, inv) & live
        is_leaf = node >= leaf_base
        count += (hit & is_leaf).int()
        push = hit & ~is_leaf
        for child in (right, left):
            slot = sp.clamp(max=63)
            stack[lanes, slot] = torch.where(push, child[node],
                                             stack[lanes, slot])
            sp = sp + push.long()
