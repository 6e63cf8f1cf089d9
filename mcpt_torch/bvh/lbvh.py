"""Karras LBVH (Morton codes + parallel per-node topology) on CPU tensors.

Port of ``mcpt/bvh/lbvh.py``, which ``mcpt`` runs on its host CPU backend
(``mcpt/scene.py:106-112``); the port builds on CPU tensors as well and moves
the result to the render device.  The topology equals ``mcpt``'s bit for bit:

- 10-bit centroid quantisation → 30-bit Morton codes; the uint32 multiplies
  of the bit expansion wrap mod 2³², held in int64 and masked;
- a *stable* argsort of the codes;
- Karras's per-node range/split search over 64-bit keys (Morton code ‖
  sorted position, so duplicate codes tie-break by position), with the same
  fixed iteration counts as ``mcpt``'s ``fori_loop``s; the common-prefix
  length is an exact leading-zero count over int64 (no float ``log2``);
- a bottom-up AABB refit of ``min(64, N)`` fixed passes.

Layout contract: ``mcpt_torch.types.BVH``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from mcpt_torch.types import BVH

_MAX_PASSES = 64  # ≥ radix-trie depth over (30-bit morton, 32-bit position) keys
_M32 = 0xFFFFFFFF


def expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v to every 3rd bit (``hlbvh.cpp:12-20``
    math), as uint32 values in an int64 tensor."""
    v = v.to(torch.int64) & _M32
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton30(centroids_unit: torch.Tensor) -> torch.Tensor:
    """(N, 3) f32 coordinates in [0, 1) → 30-bit Morton codes (int64)."""
    q = torch.clamp(centroids_unit * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((expand_bits_10(q[:, 0]) << 2) | (expand_bits_10(q[:, 1]) << 1)
            | expand_bits_10(q[:, 2]))


def _clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 0 < x < 2⁶³ as a 64-bit word: 63 minus the position
    of the top set bit, found by a binary search over shifts (exact)."""
    top = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top = torch.where((x >> (top + s)) != 0, top + s, top)
    return 63 - top


def _delta_fn(keys: torch.Tensor, n: int):
    """δ(i, j) = common-prefix length of the 64-bit keys; -1 out of range."""

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        x = keys[i] ^ keys[torch.clamp(j, 0, n - 1)]
        d = torch.where(x != 0, _clz64(torch.where(x != 0, x, 1)), 64)
        return torch.where(valid, d, -1)

    return delta


def build_lbvh(verts: torch.Tensor) -> BVH:
    """verts (N, 3, 3) f32 → flattened BVH on verts' device."""
    return build_lbvh_boxes(verts.amin(dim=1), verts.amax(dim=1))


@contextlib.contextmanager
def one_thread(device="cpu"):
    """Run PyTorch's CPU ops on one thread (a no-op for another ``device``).
    For loops of many small ops: the LBVH build is ~2000 small ops on
    ≤ 10⁵-element tensors.  On an idle 8-core host the 108k-tri build takes
    0.2 s on eight threads and 0.7 s on one; with six such processes sharing
    the cores, intra-op threads spin against each other and it takes 140 s
    on eight threads and 1.2 s on one."""
    if torch.device(device).type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def build_lbvh_boxes(tri_min: torch.Tensor, tri_max: torch.Tensor) -> BVH:
    """Karras LBVH over N arbitrary AABBs (triangles, clusters or instances:
    the builder only sees boxes); leaf ``left == right`` = input box index."""
    with one_thread():
        return _build(tri_min, tri_max)


def _build(tri_min: torch.Tensor, tri_max: torch.Tensor) -> BVH:
    n = tri_min.shape[0]
    dev = tri_min.device
    i32 = torch.int32
    if n == 1:
        return BVH(bbmin=tri_min[:1].clone(), bbmax=tri_max[:1].clone(),
                   left=torch.zeros(1, dtype=i32, device=dev),
                   right=torch.zeros(1, dtype=i32, device=dev),
                   parent=torch.full((1,), -1, dtype=i32, device=dev))

    centroid = 0.5 * (tri_min + tri_max)
    cmin = centroid.amin(dim=0)
    extent = torch.clamp(centroid.amax(dim=0) - cmin, min=1e-20)
    codes = morton30((centroid - cmin) / extent)

    order = torch.argsort(codes, stable=True)  # sorted box ids
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    keys = (codes[order] << 32) | pos  # position breaks duplicate codes
    delta = _delta_fn(keys, n)

    i = pos[:-1]
    # --- Karras range + split, vectorised over all internal nodes ---
    d = torch.where(delta(i, i + 1) >= delta(i, i - 1), 1, -1)
    delta_min = delta(i, i - d)
    n_doubling = max(2, (n - 1).bit_length() + 1)

    # upper bound by doubling; monotone, so re-checking per pass is safe
    lmax = torch.full_like(i, 2)
    for _ in range(n_doubling):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2, lmax)

    # binary search the exact range length l
    length = torch.zeros_like(i)
    for s in range(1, n_doubling + 1):
        t = lmax >> s
        cand = length + t
        ok = (t >= 1) & (delta(i, i + cand * d) > delta_min)
        length = torch.where(ok, cand, length)
    j = i + length * d
    delta_node = delta(i, j)

    # split search: largest s with δ(i, i + (s+t)·d) > δ_node
    split = torch.zeros_like(i)
    for k in range(1, n_doubling + 1):
        t = (length + (1 << k) - 1) >> k  # ceil(l / 2^k)
        cand = split + t
        ok = (t >= 1) & (delta(i, i + cand * d) > delta_node)
        split = torch.where(ok, cand, split)
    gamma = i + split * d + torch.clamp(d, max=0)

    leaf_base = n - 1
    left_child = torch.where(torch.minimum(i, j) == gamma, leaf_base + gamma,
                             gamma)
    right_child = torch.where(torch.maximum(i, j) == gamma + 1,
                              leaf_base + gamma + 1, gamma + 1)

    # --- assemble node arrays ---
    left = torch.cat([left_child, order])
    right = torch.cat([right_child, order])
    parent = torch.full((2 * n - 1,), -1, dtype=torch.int64, device=dev)
    parent[left_child] = i
    parent[right_child] = i

    # --- bottom-up AABB refit, fixed-depth passes ---
    inf = torch.full((n - 1, 3), float("inf"), dtype=torch.float32, device=dev)
    bbmin = torch.cat([inf, tri_min[order]])
    bbmax = torch.cat([-inf, tri_max[order]])
    for _ in range(min(_MAX_PASSES, n)):
        new_min = torch.minimum(bbmin[left_child], bbmin[right_child])
        new_max = torch.maximum(bbmax[left_child], bbmax[right_child])
        bbmin[:leaf_base] = new_min
        bbmax[:leaf_base] = new_max

    return BVH(bbmin=bbmin, bbmax=bbmax, left=left.to(i32),
               right=right.to(i32), parent=parent.to(i32))


def validate_bvh(bvh: BVH, verts) -> dict:
    """Host-side structural invariants: parent/child consistency, leaf
    coverage (each triangle in exactly one leaf), AABB containment."""
    left = bvh.left.cpu().numpy()
    right = bvh.right.cpu().numpy()
    parent = bvh.parent.cpu().numpy()
    bbmin = bvh.bbmin.cpu().numpy()
    bbmax = bvh.bbmax.cpu().numpy()
    v = np.asarray(verts.cpu() if isinstance(verts, torch.Tensor) else verts)
    n = bvh.n_tris
    errors = []
    if n > 1:
        if not np.array_equal(np.sort(left[n - 1:]), np.arange(n)):
            errors.append("leaf coverage: not a permutation of triangle ids")
        if not np.array_equal(left[n - 1:], right[n - 1:]):
            errors.append("leaf encoding: left != right")
        for k in range(n - 1):
            for c in (left[k], right[k]):
                if parent[c] != k:
                    errors.append(f"parent[{c}] = {parent[c]} != {k}")
                    break
        if parent[0] != -1:
            errors.append("root parent != -1")
        for k in range(n - 1):
            for c in (left[k], right[k]):
                if ((bbmin[k] > bbmin[c] + 1e-5).any()
                        or (bbmax[k] < bbmax[c] - 1e-5).any()):
                    errors.append(f"AABB of node {k} does not contain "
                                  f"child {c}")
                    break
        lt = left[n - 1:]
        if ((np.abs(bbmin[n - 1:] - v[lt].min(axis=1)) > 1e-5).any()
                or (np.abs(bbmax[n - 1:] - v[lt].max(axis=1)) > 1e-5).any()):
            errors.append("leaf AABB mismatch with triangle bounds")
    return {"ok": not errors, "errors": errors}
