"""Batched treelet SAH restructuring on a device: the ``treeletGPU`` builder.

Port of ``mcpt/bvh/treelet_device.py``, ``mcpt``'s answer to the
reference's warp-per-treelet kernel (``kernels/treeletBVH.cl:230-531``).
The schedule is level-synchronous:

- internal nodes are grouped by their height in the initial tree (equal
  height ⇒ disjoint subtrees ⇒ the treelets of a round are independent);
- each round optimises a batch of ``BATCH`` treelet roots as one tensor
  program on the BVH's device: greedy expansion to 7 treelet leaves, subset
  boxes by the low-bit recurrence, the subset DP level by popcount over
  precomputed partition tables, the reconstruction, and scatters that drop
  padded and non-improved roots.

Only roots whose subtree holds at least 7 leaves are optimised (the set of
leaves under a root never changes, so this is known on the host up front).

``mcpt`` runs this as XLA; here it is PyTorch ops, as many small launches a
round on CUDA.  Two details keep the results equal to ``mcpt``'s: the DP
takes the first minimum (``torch.argmin`` and ``jnp.argmin`` both do), and a
one-bit subset's position comes from an integer table, not from
``round(log2(·))``.  The scatters of a round drop their writes into a spare
last row instead of masking, so no round reads anything back to the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mcpt_torch.bvh.metrics import C_INN, C_TRI
from mcpt_torch.bvh.treelet import MAX_LEAVES, _node_heights
from mcpt_torch.types import BVH

TN = MAX_LEAVES  # 7
FULL = (1 << TN) - 1
BATCH = 1024  # treelet roots per round


def _dp_tables():
    """Per popcount level k ≥ 2: the subsets of size k and their canonical
    partitions p < s^p, (S_k,) and (S_k, 2^(k-1) - 1)."""
    levels = []
    for k in range(2, TN + 1):
        subsets = [s for s in range(1, FULL + 1) if bin(s).count("1") == k]
        width = (1 << (k - 1)) - 1
        ptab = np.zeros((len(subsets), width), np.int64)
        for i, s in enumerate(subsets):
            ps = []
            p = (s - 1) & s
            while p:
                if p < (s ^ p):
                    ps.append(p)
                p = (p - 1) & s
            ptab[i] = ps
        levels.append((np.asarray(subsets, np.int64), ptab))
    return levels


_LEVELS = _dp_tables()
# each subset's lowest bit, its position, and the subsets by popcount
_LOWBIT = np.asarray([s & -s for s in range(FULL + 1)], np.int64)
_LOWPOS = np.asarray([(s & -s).bit_length() - 1 if s else 0
                      for s in range(FULL + 1)], np.int64)
_BY_POPCOUNT = [np.asarray([s for s in range(1, FULL + 1)
                            if bin(s).count("1") == k], np.int64)
                for k in range(1, TN + 1)]


def _area(bmin, bmax):
    d = torch.clamp(bmax - bmin, min=0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


class _Tables:
    """The constant tables of a round, on one device."""

    def __init__(self, dev):
        def put(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)

        self.levels = [(put(ss), put(pp)) for ss, pp in _LEVELS]
        self.lowbit, self.lowpos = put(_LOWBIT), put(_LOWPOS)
        self.by_popcount = [put(s) for s in _BY_POPCOUNT]


def _optimize_batch(tree, roots, valid, tab: _Tables, leaf_base: int):
    """Optimise one batch of 7-leaf treelet roots in place.  ``tree`` =
    (bbmin, bbmax, left, right, parent, cost), each with one spare last row
    that takes the dropped writes."""
    bbmin, bbmax, left, right, parent, cost = tree
    drop = left.shape[0] - 1
    dev = roots.device
    b = roots.shape[0]
    r_ = torch.arange(b, device=dev)
    cols = torch.arange(TN, device=dev)

    # --- greedy expansion to 7 treelet leaves (treeletBVH.cpp:42-91) ---
    leaves = torch.zeros((b, TN), dtype=torch.int64, device=dev)
    leaves[:, 0] = left[roots]
    leaves[:, 1] = right[roots]
    opened = torch.zeros((b, TN - 2), dtype=torch.int64, device=dev)
    for step in range(TN - 2):
        count = 2 + step
        la = _area(bbmin[leaves], bbmax[leaves])  # (B, 7)
        cand = (leaves < leaf_base) & (cols[None, :] < count)
        la = torch.where(cand, la, -torch.inf)
        pick = torch.argmax(la, dim=1)  # the first maximum, as jnp.argmax
        x = leaves[r_, pick]
        opened[:, step] = x
        leaves[r_, pick] = left[x]
        leaves[:, count] = right[x]

    lmin, lmax = bbmin[leaves], bbmax[leaves]  # (B, 7, 3)
    lcost = cost[leaves]  # (B, 7)

    # --- subset boxes by the low-bit recurrence, one popcount level a step
    # (a level's rests lie in the level below) ---
    smin = torch.full((b, FULL + 1, 3), torch.inf, device=dev)
    smax = torch.full((b, FULL + 1, 3), -torch.inf, device=dev)
    singles = tab.by_popcount[0]
    smin[:, singles] = lmin
    smax[:, singles] = lmax
    for ss in tab.by_popcount[1:]:
        rest = ss ^ tab.lowbit[ss]
        bit = tab.lowpos[ss]
        smin[:, ss] = torch.minimum(smin[:, rest], lmin[:, bit])
        smax[:, ss] = torch.maximum(smax[:, rest], lmax[:, bit])
    s_area = _area(smin, smax)  # (B, 128)

    # --- subset DP in popcount order (treeletBVH.cpp:123-208) ---
    csub = torch.full((b, FULL + 1), torch.inf, device=dev)
    csub[:, singles] = lcost
    part = torch.zeros((b, FULL + 1), dtype=torch.int64, device=dev)
    for ss, pp in tab.levels:
        cand = csub[:, pp] + csub[:, ss[:, None] ^ pp]  # (B, S, W)
        best = cand.amin(dim=2)
        arg = torch.argmin(cand, dim=2)  # the first minimum, as jnp.argmin
        csub[:, ss] = best + C_INN * s_area[:, ss]
        part[:, ss] = pp[torch.arange(ss.shape[0], device=dev)[None, :], arg]

    improved = valid & (csub[:, FULL] < cost[roots] - 1e-5)

    # --- reconstruction: a subset stack, 6 splits ---
    # node ids in pop order: the root first (the rebuilt root IS the root,
    # so its ancestors' links and boxes stay valid), then the opened nodes
    pool = torch.cat([roots[:, None], opened], dim=1)  # (B, 6)
    sstack = torch.zeros((b, TN), dtype=torch.int64, device=dev)
    nstack = torch.zeros((b, TN), dtype=torch.int64, device=dev)
    sstack[:, 0] = FULL
    nstack[:, 0] = roots
    sp = torch.ones(b, dtype=torch.int64, device=dev)
    next_pool = torch.ones(b, dtype=torch.int64, device=dev)
    upd = torch.zeros((4, b, TN - 1), dtype=torch.int64, device=dev)
    for step in range(TN - 1):
        sp = sp - 1
        s = sstack[r_, sp]
        nid = nstack[r_, sp]
        p = part[r_, s]
        q = s ^ p
        children = []
        for sub in (q, p):  # q is pushed first, so p (left) pops first
            single = (sub & (sub - 1)) == 0
            leaf_id = leaves[r_, tab.lowpos[sub]]
            new_nid = pool[r_, next_pool.clamp(0, TN - 2)]
            children.append(torch.where(single, leaf_id, new_nid))
            sl = sp.clamp(0, TN - 1)
            sstack[r_, sl] = torch.where(single, sstack[r_, sl], sub)
            nstack[r_, sl] = torch.where(single, nstack[r_, sl], new_nid)
            grow = (~single).long()
            sp = sp + grow
            next_pool = next_pool + grow
        ch_q, ch_p = children
        upd[0, :, step] = nid
        upd[1, :, step] = s
        upd[2, :, step] = ch_p
        upd[3, :, step] = ch_q

    # --- apply; padded and non-improved roots write into the spare row ---
    keep = improved[:, None].expand(-1, TN - 1).reshape(-1)
    nid, s, lch, rch = (u.reshape(-1) for u in upd)
    bi = r_[:, None].expand(-1, TN - 1).reshape(-1)
    tgt = torch.where(keep, nid, drop)
    left[tgt] = lch
    right[tgt] = rch
    parent[torch.where(keep, lch, drop)] = nid
    parent[torch.where(keep, rch, drop)] = nid
    bbmin[tgt] = smin[bi, s]
    bbmax[tgt] = smax[bi, s]
    cost[tgt] = csub[bi, s]


def optimize_treelets_device(bvh: BVH, verbose: bool = False) -> BVH:
    """Treelet optimisation on ``bvh``'s device; the contract of
    ``treelet.optimize_treelets``.  Prints its build time, as the reference
    does (``BVH/treeletBVH.cpp:437``), when ``verbose``."""
    from mcpt_torch.bvh.lbvh import one_thread

    t0 = time.perf_counter()
    dev = bvh.left.device
    left_h = bvh.left.cpu().numpy().astype(np.int64)
    right_h = bvh.right.cpu().numpy().astype(np.int64)
    n_nodes = left_h.shape[0]
    n = (n_nodes + 1) // 2
    if n < 8:
        return bvh
    leaf_base = n - 1

    # host schedule: initial heights (order) and subtree leaf counts
    # (7-leaf eligibility), both invariant under the restructuring
    heights = _node_heights(left_h, right_h, leaf_base, n_nodes)
    order = np.argsort(heights[:leaf_base], kind="stable")
    counts = np.ones(n_nodes, np.int64)
    for v in order:
        counts[v] = counts[left_h[v]] + counts[right_h[v]]
    eligible = counts[:leaf_base] >= TN

    # initial subtree SAH costs, bottom-up on the host in float64
    bmn = bvh.bbmin.cpu().numpy().astype(np.float64)
    bmx = bvh.bbmax.cpu().numpy().astype(np.float64)
    d = np.maximum(bmx - bmn, 0.0)
    a = 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])
    cost_h = np.zeros(n_nodes, np.float64)
    cost_h[leaf_base:] = C_TRI * a[leaf_base:]
    for v in order:
        cost_h[v] = C_INN * a[v] + cost_h[left_h[v]] + cost_h[right_h[v]]

    def spare(t, dtype):  # a copy with one spare last row
        t = t.to(dev, dtype)
        return torch.cat([t, torch.zeros_like(t[:1])])

    tree = (spare(bvh.bbmin, torch.float32), spare(bvh.bbmax, torch.float32),
            spare(bvh.left, torch.int64), spare(bvh.right, torch.int64),
            spare(bvh.parent, torch.int64),
            spare(torch.from_numpy(cost_h), torch.float32))
    tab = _Tables(dev)
    n_rounds = 0
    with one_thread(dev):
        for h in range(1, int(heights[:leaf_base].max()) + 1):
            roots_h = np.nonzero((heights[:leaf_base] == h) & eligible)[0]
            for lo in range(0, len(roots_h), BATCH):
                chunk = roots_h[lo:lo + BATCH]
                padded = np.full(BATCH, chunk[0], np.int64)
                padded[:len(chunk)] = chunk
                valid = np.arange(BATCH) < len(chunk)
                _optimize_batch(tree, torch.from_numpy(padded).to(dev),
                                torch.from_numpy(valid).to(dev), tab,
                                leaf_base)
                n_rounds += 1
    bbmin, bbmax, left, right, parent, _ = (t[:-1] for t in tree)
    out = BVH(bbmin=bbmin.contiguous(), bbmax=bbmax.contiguous(),
              left=left.to(torch.int32), right=right.to(torch.int32),
              parent=parent.to(torch.int32))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if verbose:
        print(f"treeletGPU build time: {(time.perf_counter() - t0) * 1e3:.1f}"
              f" ms ({n_rounds} batched rounds on {dev.type})")
    return out
