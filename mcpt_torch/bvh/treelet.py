"""Treelet-based SAH restructuring (Karras & Aila, HPG 2013).

Port of ``mcpt/bvh/treelet.py`` with its two implementations:

- the C++ optimiser (``mcpt_torch/csrc/host/treelet.cpp``, the port's copy of
  ``mcpt``'s native ``mcpt_treelet_optimize``), which is what ``mcpt`` runs
  when building a scene.  It is built with ``g++`` at first use
  (``kernels._build.load_host``); if that fails, this module raises, because
  the numpy optimiser gives another topology and so other cluster tables;
- the numpy optimiser (``native=False``), ``mcpt``'s ``use_native="never"``
  path, kept as the readable reference of the algorithm.

Algorithm (reference ``BVH/treeletBVH.cpp:15-365``): bottom-up sweep over the
internal nodes in height order; per treelet root, greedy max-surface-area
expansion to ≤ 7 treelet leaves; optimal re-partition by dynamic programming
over all subsets; reconstruction reusing the freed internal nodes.  The leaf
set of a treelet is invariant, so no update propagates above it.
"""

from __future__ import annotations

import numpy as np
import torch

from mcpt_torch.bvh.metrics import C_INN, C_TRI
from mcpt_torch.types import BVH

MAX_LEAVES = 7  # treelet size, reference MAX_NODE (treeletBVH.cpp:15-16)
_EPS = 1e-7  # minimum SAH gain for a rebuild


def _partition_tables(n: int):
    """For each subset s of n bits (popcount ≥ 2) the canonical partitions
    (p, s^p) with p < s^p, as flat (idx_s, idx_p) arrays."""
    idx_s, idx_p = [], []
    for s in range(1, 1 << n):
        if bin(s).count("1") < 2:
            continue
        p = (s - 1) & s
        while p:
            if p < s ^ p:
                idx_s.append(s)
                idx_p.append(p)
            p = (p - 1) & s
    return np.asarray(idx_s, np.int64), np.asarray(idx_p, np.int64)


_TABLES = {n: _partition_tables(n) for n in range(2, MAX_LEAVES + 1)}


def _node_heights(left, right, leaf_base, n_nodes):
    h = np.zeros(n_nodes, np.int64)
    for _ in range(n_nodes):
        new_h = np.zeros_like(h)
        new_h[:leaf_base] = 1 + np.maximum(h[left[:leaf_base]],
                                           h[right[:leaf_base]])
        if (new_h == h).all():
            break
        h = new_h
    return h


def optimize_treelets(bvh: BVH, native: bool = True) -> BVH:
    """Restructure the BVH to (locally) minimal SAH; returns a new BVH on
    ``bvh``'s device with the same leaf set and layout contract."""
    if native:
        return _optimize_native(bvh)
    return _optimize_numpy(bvh)


def _optimize_native(bvh: BVH) -> BVH:
    from mcpt_torch.kernels import _build

    lib = _build.load_host()
    # owned C-order copies: the optimiser rewrites them in place
    bbmin, bbmax, left, right, parent = (
        np.array(t.cpu().numpy(), dtype, order="C")
        for t, dtype in zip(bvh, (np.float32, np.float32, np.int32,
                                  np.int32, np.int32)))
    lib.mcpt_treelet_optimize(bvh.n_tris, bbmin.ctypes.data,
                              bbmax.ctypes.data, left.ctypes.data,
                              right.ctypes.data, parent.ctypes.data)
    dev = bvh.left.device
    return BVH(*(torch.from_numpy(a).to(dev)
                 for a in (bbmin, bbmax, left, right, parent)))


def _optimize_numpy(bvh: BVH) -> BVH:
    left = bvh.left.cpu().numpy().astype(np.int64)
    right = bvh.right.cpu().numpy().astype(np.int64)
    parent = bvh.parent.cpu().numpy().astype(np.int64)
    bbmin = bvh.bbmin.cpu().numpy().astype(np.float64)
    bbmax = bvh.bbmax.cpu().numpy().astype(np.float64)
    n_nodes = left.shape[0]
    n = (n_nodes + 1) // 2
    if n < 4:
        return bvh
    leaf_base = n - 1

    def area(i):
        d = np.maximum(bbmax[i] - bbmin[i], 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    # subtree SAH costs, bottom-up (reference recurseGet, treeletBVH.cpp:301-325)
    cost = np.zeros(n_nodes, np.float64)
    cost[leaf_base:] = C_TRI * area(np.arange(leaf_base, n_nodes))
    heights = _node_heights(left, right, leaf_base, n_nodes)
    order = np.argsort(heights[:leaf_base], kind="stable")
    for r in order:
        cost[r] = C_INN * area(r) + cost[left[r]] + cost[right[r]]

    # bottom-up sweep (ascending height ⇒ children already final)
    for r in order:
        # --- greedy treelet expansion (treeletBVH.cpp:42-91) ---
        leaves = [left[r], right[r]]
        internals = [r]
        while len(leaves) < MAX_LEAVES:
            best, best_a = -1, -1.0
            for li, node in enumerate(leaves):
                if node < leaf_base:
                    a = area(node)
                    if a > best_a:
                        best, best_a = li, a
            if best < 0:
                break
            x = leaves.pop(best)
            internals.append(x)
            leaves.extend((left[x], right[x]))
        tn = len(leaves)
        if tn < 3:
            continue

        idx_s, idx_p = _TABLES[tn]
        full = (1 << tn) - 1

        # subset AABBs + areas
        lmin = bbmin[leaves]
        lmax = bbmax[leaves]
        smin = np.empty((full + 1, 3))
        smax = np.empty((full + 1, 3))
        smin[0] = np.inf
        smax[0] = -np.inf
        for s in range(1, full + 1):
            low = s & (-s)
            bit = low.bit_length() - 1
            rest = s ^ low
            smin[s] = np.minimum(smin[rest], lmin[bit]) if rest else lmin[bit]
            smax[s] = np.maximum(smax[rest], lmax[bit]) if rest else lmax[bit]
        d = np.maximum(smax - smin, 0.0)
        s_area = 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                        + d[:, 2] * d[:, 0])

        # DP over subsets in popcount order (vectorised per level)
        csub = np.full(full + 1, np.inf)
        part = np.zeros(full + 1, np.int64)
        for i, node in enumerate(leaves):
            csub[1 << i] = cost[node]
        pc = np.array([bin(s).count("1") for s in idx_s])
        for k in range(2, tn + 1):
            sel = pc == k
            if not sel.any():
                continue
            ss = idx_s[sel]
            pp = idx_p[sel]
            cand = csub[pp] + csub[ss ^ pp] + C_INN * s_area[ss]
            np.minimum.at(csub, ss, cand)
            # recover the argmin partition
            best_for = {}
            for s_, p_, c_ in zip(ss, pp, cand):
                if c_ <= csub[s_] + 1e-12 and (
                        s_ not in best_for or c_ < best_for[s_][0]):
                    best_for[s_] = (c_, p_)
            for s_, (_, p_) in best_for.items():
                part[s_] = p_

        if csub[full] >= cost[r] - _EPS:
            continue  # no improvement

        # --- reconstruction (treeletBVH.cpp:210-284) ---
        def build_rec(s):
            s = int(s)
            if s & (s - 1) == 0:
                return leaves[s.bit_length() - 1]
            nid = pool.pop()
            p = int(part[s])
            lch = build_rec(p)
            rch = build_rec(s ^ p)
            left[nid] = lch
            right[nid] = rch
            parent[lch] = nid
            parent[rch] = nid
            bbmin[nid] = smin[s]
            bbmax[nid] = smax[s]
            cost[nid] = C_INN * s_area[s] + cost[lch] + cost[rch]
            return nid

        # pool is a stack (pop from end): r on top → the rebuilt root IS r,
        # so r's parent link and the ancestors' AABBs stay valid
        pool = [x for x in internals if x != r] + [r]
        build_rec(full)

    dev = bvh.left.device

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)

    return BVH(bbmin=t(bbmin, torch.float32), bbmax=t(bbmax, torch.float32),
               left=t(left, torch.int32), right=t(right, torch.int32),
               parent=t(parent, torch.int32))
