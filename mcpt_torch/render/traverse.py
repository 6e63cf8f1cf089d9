"""Ray–scene intersection for the wavefront engine (the port of
``mcpt/render/traverse.py``).

- ``moller_trumbore`` and ``intersect_brute``: the closest hit over every
  triangle (scenes without Wald transforms);
- ``intersect_wald``: the closest hit over every triangle's Wald transform,
  the brute path of scenes that carry them.  ``mcpt`` writes it as two
  contractions at ``Precision.HIGHEST``; here the contraction is written out
  elementwise in full float32, in the same order (no matrix unit, so no TF32);
- ``intersect_bvh``: the batched per-ray stack walk of the binary BVH,
  ``MAX_STACK`` entries per ray with ``mcpt``'s clamped push slot;
- ``resolve_method``, ``intersect_scene`` and ``occluded``: the dispatch.
  The ``cluster`` method goes to ``mcpt_torch.kernels.traverse_kernel``
  (kernel 4 on CUDA tensors, its plain version on CPU tensors).

Every query returns a ``types.Hit``: t = inf and tri = -1 on a miss.
"""

from __future__ import annotations

import math

import torch

from mcpt_torch.bvh.lbvh import one_thread
from mcpt_torch.types import BVH, Geometry, Hit

_DET_EPS = 1e-12
_T_MIN = 1e-4
MAX_STACK = 64  # the reference's stack[64] (objdef.h:244)


def dot(a, b):
    """Dot product over the last axis of 3, summed left to right (the order
    ``mcpt``'s three-term sums round in)."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def moller_trumbore(origin, direction, v0, v1, v2, t_min=_T_MIN):
    """Batched Möller–Trumbore, all arguments (..., 3) → (t, hit); a miss
    gets t = inf.  Back faces hit, as in the reference."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = _cross(direction, e2)
    det = dot(e1, pvec)
    ok_det = det.abs() > _DET_EPS
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tvec = origin - v0
    u = dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return torch.where(hit, t, math.inf), hit


def _finish_hit(geom: Geometry, origin, direction, t, tri) -> Hit:
    """Hit point and geometric normal of the winning triangle ids."""
    valid = tri >= 0
    normal = geom.normals[torch.clamp(tri, min=0).long()]
    point = origin + direction * torch.where(valid, t, 0.0)[:, None]
    return Hit(t=torch.where(valid, t, math.inf),
               tri=torch.where(valid, tri, -1).to(torch.int32),
               point=point,
               normal=torch.where(valid[:, None], normal, 0.0))


def _limit(t, tri, t_max):
    if t_max is None:
        return t, tri
    ok = t < t_max
    return torch.where(ok, t, math.inf), torch.where(ok, tri, -1)


def intersect_brute(geom: Geometry, origin, direction, t_max=None,
                    chunk: int = 64) -> Hit:
    """Closest hit by testing every triangle, ``chunk`` at a time; the first
    triangle wins an exact tie."""
    n = geom.count
    r = origin.shape[0]
    dev = origin.device
    best_t = torch.full((r,), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((r,), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(r, device=dev)
    for base in range(0, n, chunk):
        vc = geom.verts[base:base + chunk]
        t, _ = moller_trumbore(origin[:, None], direction[:, None],
                               vc[None, :, 0], vc[None, :, 1], vc[None, :, 2])
        ci = torch.argmin(t, dim=1)
        ct = t[rows, ci]
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_i = torch.where(better, base + ci, best_i)
    best_t, best_i = _limit(best_t, best_i, t_max)
    return _finish_hit(geom, origin, direction, best_t, best_i)


def wald_rows(wald) -> torch.Tensor:
    """``WaldTris`` → (T, 12) rows: 0:9 the transform A row-major, 9:12 b
    (the megakernel's row layout)."""
    t_count = wald.b.shape[0]
    return torch.cat([wald.w.permute(1, 2, 0).reshape(t_count, 9), wald.b],
                     dim=1).contiguous()


def intersect_wald(wald, geom: Geometry, origin, direction,
                   t_max=None) -> Hit:
    """Closest hit through every triangle's Wald transform: t = -op_z/dp_z,
    (u, v) = op_xy + t·dp_xy, a hit inside the unit triangle past 1e-4; the
    first row wins an exact tie."""
    from mcpt_torch.kernels import megakernel as mk

    best_t, best_i = mk._closest(wald_rows(wald), *origin.unbind(1),
                                 *direction.unbind(1), _T_MIN)
    hit = best_t < mk._MISS
    best_t = torch.where(hit, best_t, math.inf)
    best_i = torch.where(hit, best_i, -1)
    best_t, best_i = _limit(best_t, best_i, t_max)
    return _finish_hit(geom, origin, direction, best_t, best_i)


def _safe_inv(d):
    tiny = 1e-30
    return 1.0 / torch.where(d.abs() < tiny, torch.where(d < 0.0, -tiny, tiny),
                             d)


def _slab(bbmin, bbmax, origin, inv_dir, t_best):
    """Slab test of boxes against rays → (hit, t_near)."""
    t0 = (bbmin - origin) * inv_dir
    t1 = (bbmax - origin) * inv_dir
    tnear = torch.minimum(t0, t1).amax(dim=-1)
    tfar = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tfar >= torch.clamp(tnear, min=0.0)) & (tnear < t_best)
    return hit, tnear


def intersect_bvh(bvh: BVH, geom: Geometry, origin, direction, active=None,
                  max_stack: int = MAX_STACK) -> Hit:
    """Closest hit by the batched stack walk of the binary BVH: every ray
    pops one node per step, tests a leaf's triangle (Möller–Trumbore) or
    both children's boxes, and pushes the hit children far first, into slot
    ``min(sp, max_stack - 1)``.  ``active`` rays only; the others miss."""
    r = origin.shape[0]
    dev = origin.device
    inv_dir = _safe_inv(direction)
    if active is None:
        active = torch.ones((r,), dtype=torch.bool, device=dev)
    root_hit, _ = _slab(bvh.bbmin[0], bvh.bbmax[0], origin, inv_dir,
                        math.inf)
    start = active & root_hit
    if bvh.n_tris == 1:  # the root is the only (leaf) node
        v = geom.verts[0]
        t, hit = moller_trumbore(origin, direction, v[0], v[1], v[2])
        ok = hit & start
        return _finish_hit(geom, origin, direction,
                           torch.where(ok, t, math.inf),
                           torch.where(ok, 0, -1))

    with one_thread(dev):  # a loop of many small ops: lbvh.one_thread
        return _walk_bvh(bvh, geom, origin, direction, inv_dir, start,
                         max_stack)


def _walk_bvh(bvh: BVH, geom: Geometry, origin, direction, inv_dir, start,
              max_stack: int) -> Hit:
    r = origin.shape[0]
    dev = origin.device
    n = bvh.n_tris
    leaf_base = n - 1
    boxes6 = torch.cat([bvh.bbmin, bvh.bbmax], dim=1)  # (2N-1, 6)
    children = torch.stack([bvh.left, bvh.right], dim=1).long()  # (2N-1, 2)
    verts9 = geom.verts.reshape(n, 9)
    stack = torch.zeros((r, max_stack), dtype=torch.int64, device=dev)
    sp = start.to(torch.int64)
    best_t = torch.full((r,), math.inf, dtype=torch.float32, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    while True:
        lv = torch.nonzero(sp > 0).squeeze(1)
        if lv.numel() == 0:
            break
        o, d, inv = origin[lv], direction[lv], inv_dir[lv]
        s = sp[lv] - 1
        node = stack[lv, torch.clamp(s, max=max_stack - 1)]
        is_leaf = node >= leaf_base
        ch = children[node]
        lc, rc = ch[:, 0], ch[:, 1]

        # leaf: Möller–Trumbore on the node's triangle
        tri_id = torch.clamp(lc, 0, n - 1)
        v = verts9[tri_id]
        t_hit, m_hit = moller_trumbore(o, d, v[:, 0:3], v[:, 3:6], v[:, 6:9])
        take = is_leaf & m_hit & (t_hit < best_t[lv])
        t_new = torch.where(take, t_hit, best_t[lv])
        best_t[lv] = t_new
        best_tri[lv] = torch.where(take, tri_id, best_tri[lv])

        # internal: test both children, push the far one first
        cb = boxes6[torch.where(is_leaf[:, None], 0, ch)]  # (L, 2, 6)
        hit_l, tn_l = _slab(cb[:, 0, 0:3], cb[:, 0, 3:6], o, inv, t_new)
        hit_r, tn_r = _slab(cb[:, 1, 0:3], cb[:, 1, 3:6], o, inv, t_new)
        hit_l = hit_l & ~is_leaf
        hit_r = hit_r & ~is_leaf
        near_is_l = tn_l <= tn_r
        near = torch.where(near_is_l, lc, rc)
        far = torch.where(near_is_l, rc, lc)
        hit_near = torch.where(near_is_l, hit_l, hit_r)
        hit_far = torch.where(near_is_l, hit_r, hit_l)
        for push, child in ((hit_far, far), (hit_near, near)):
            slot = torch.clamp(s, max=max_stack - 1)
            stack[lv, slot] = torch.where(push, child, stack[lv, slot])
            s = s + push.to(torch.int64)
        sp[lv] = s
    return _finish_hit(geom, origin, direction, best_t, best_tri)


def resolve_method(scene, method: str = "auto") -> str:
    """``auto`` → ``brute`` up to 512 triangles; ``cluster`` (kernel 4) when
    the scene carries a cluster BVH on a CUDA device; ``bvh`` otherwise
    (``mcpt``'s rule, with "on the chip" meaning a CUDA device)."""
    if method != "auto":
        return method
    if scene.geom.count <= 512:
        return "brute"
    if scene.clusters is not None and scene.geom.verts.device.type == "cuda":
        return "cluster"
    return "bvh"


def intersect_scene(scene, origin, direction, active=None,
                    method: str = "auto") -> Hit:
    """Closest hit by ``resolve_method``; the brute path uses the Wald
    transforms when the scene carries them."""
    method = resolve_method(scene, method)
    if method == "cluster":
        from mcpt_torch.kernels import traverse_kernel as tk

        if scene.clusters is None:
            raise ValueError("scene has no cluster BVH")
        return tk.intersect_clusters(scene.clusters, origin, direction,
                                     active=active)
    if method == "brute":
        if scene.wald is not None:
            hit = intersect_wald(scene.wald, scene.geom, origin, direction)
        else:
            hit = intersect_brute(scene.geom, origin, direction)
        if active is not None:
            hit = hit._replace(t=torch.where(active, hit.t, math.inf),
                               tri=torch.where(active, hit.tri, -1))
        return hit
    if method == "bvh":
        return intersect_bvh(scene.bvh, scene.geom, origin, direction,
                             active=active)
    raise ValueError(f"unknown intersector {method!r}")


def occluded(scene, origin, direction, t_max, active=None,
             method: str = "auto") -> torch.Tensor:
    """Shadow-ray query: a hit with t < t_max·(1 - 1e-3)?  Clustered scenes
    use the any-hit walk; the other methods answer through the closest
    hit."""
    method = resolve_method(scene, method)
    if method == "cluster":
        from mcpt_torch.kernels import traverse_kernel as tk

        return tk.occluded_clusters(scene.clusters, origin, direction,
                                    t_max * (1.0 - 1e-3), active=active)
    hit = intersect_scene(scene, origin, direction, active=active,
                          method=method)
    return hit.t < t_max * (1.0 - 1e-3)
