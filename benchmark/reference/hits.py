"""The reference's own closest-hit and any-hit queries, in plain PyTorch.

No tree: the triangles are sorted by the Morton code of their centroids
(the reference's own order), cut into chunks of ``chunk`` triangles, and
each chunk's box, widened by a ten-thousandth of the scene's diagonal, only
culls.  Every triangle of every chunk whose box a ray crosses gets the
Wald unit-triangle test, with the operations in the order the scene
format's intersector performs them, so a hit's ``t`` is the same float as
any exact intersector of these rows computes.  The closest hit is the
smallest ``t``; among equal ``t`` (coplanar faces, such as a box standing on
the floor), the triangle listed first in the scene.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.path import MISS

_BOX_ELEMS = 1 << 25  # ray × box tests held at once
_PAIR_ELEMS = 1 << 23  # ray × triangle tests held at once


def _expand_bits(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x = (x | (x << 16)) & np.uint64(0x030000FF)
    x = (x | (x << 8)) & np.uint64(0x0300F00F)
    x = (x | (x << 4)) & np.uint64(0x030C30C3)
    x = (x | (x << 2)) & np.uint64(0x09249249)
    return x


def wald(a, o, d, t_min, t_max):
    """Wald test of rows ``a`` (…, 16) against rays o, d (3-tuples that
    broadcast against a[..., 0]) → (t, hit in (t_min, t_max))."""
    opz = a[..., 6] * o[0] + a[..., 7] * o[1] + a[..., 8] * o[2] + a[..., 11]
    dpz = a[..., 6] * d[0] + a[..., 7] * d[1] + a[..., 8] * d[2]
    th = -opz / dpz
    opx = a[..., 0] * o[0] + a[..., 1] * o[1] + a[..., 2] * o[2] + a[..., 9]
    dpx = a[..., 0] * d[0] + a[..., 1] * d[1] + a[..., 2] * d[2]
    u = opx + th * dpx
    opy = a[..., 3] * o[0] + a[..., 4] * o[1] + a[..., 5] * o[2] + a[..., 10]
    dpy = a[..., 3] * d[0] + a[..., 4] * d[1] + a[..., 5] * d[2]
    v = opy + th * dpy
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (th > t_min)
          & (th < t_max))
    return th, ok


class _Rows:
    """The rows of a group of chunks, one coefficient gathered at a time
    (``wald`` reads ``a[..., j]``): (G, chunk) for each of the 12."""

    def __init__(self, planes, ch):
        self.planes, self.ch, self.got = planes, ch, {}

    def __getitem__(self, key):
        j = key[1]
        if j not in self.got:
            # one chunk: every ray tests it, so its rows broadcast
            self.got[j] = (self.planes[j][0][None] if self.ch is None
                           else self.planes[j][self.ch])
        return self.got[j]


class Hits:
    """Closest- and any-hit queries over a scene's rows, on ``device`` in
    precision ``dt`` (the boxes always in float32)."""

    def __init__(self, rows: np.ndarray, verts: np.ndarray, device,
                 dt=torch.float32, chunk: int = 64):
        cen = verts.astype(np.float64).mean(axis=1)
        lo = cen.min(axis=0)
        ext = np.maximum(cen.max(axis=0) - lo, 1e-20)
        q = np.clip((cen - lo) / ext * 1024.0, 0.0, 1023.0).astype(np.uint64)
        code = ((_expand_bits(q[:, 2]) << np.uint64(2))
                | (_expand_bits(q[:, 1]) << np.uint64(1))
                | _expand_bits(q[:, 0]))
        order = np.argsort(code, kind="stable")
        n = len(order)
        n_pad = -(-n // chunk) * chunk
        r = np.zeros((n_pad, 16), np.float32)
        r[:n] = rows[order]
        r[n:, 11] = 1.0  # pad rows: A = 0, b = (0, 0, 1): t = -inf, no hit
        bmin = np.full((n_pad, 3), np.inf, np.float32)
        bmax = np.full((n_pad, 3), -np.inf, np.float32)
        bmin[:n] = verts[order].min(axis=1)
        bmax[:n] = verts[order].max(axis=1)
        flat = verts.reshape(-1, 3)
        pad = 1e-4 * float(np.linalg.norm(flat.max(axis=0)
                                          - flat.min(axis=0)))
        nc = n_pad // chunk
        self.chunk, self.n_chunks, self.dt = chunk, nc, dt
        self.rows = torch.from_numpy(r).to(device, dt)
        self.planes = self.rows[:, :12].t().reshape(12, n_pad // chunk,
                                                    chunk).contiguous()
        # each sorted row's index in the scene's list, and the rows by it
        ids = np.concatenate([order, np.arange(n, n_pad)])
        self.scene_id = torch.from_numpy(ids).to(device)
        self.by_id = torch.from_numpy(r[np.argsort(ids)]).to(device, dt)
        self.lo = torch.from_numpy(
            bmin.reshape(nc, chunk, 3).min(axis=1) - pad).to(device)
        self.hi = torch.from_numpy(
            bmax.reshape(nc, chunk, 3).max(axis=1) + pad).to(device)

    def _pairs(self, o, d, limit):
        """(ray, chunk) pairs whose box the ray crosses within [0, limit]
        (with one chunk, every ray)."""
        n = o[0].shape[0]
        if self.n_chunks == 1:
            ray = torch.arange(n, device=o[0].device)
            return torch.stack([ray, torch.zeros_like(ray)], dim=1)
        block = max(1, min(1 << 20, _BOX_ELEMS // self.n_chunks))
        out = []
        for s in range(0, n, block):
            sl = slice(s, s + block)
            tn = torch.full((min(block, n - s), self.n_chunks), -np.inf,
                            device=o[0].device)
            tf = torch.full_like(tn, np.inf)
            for k in range(3):
                ok = o[k][sl].float()[:, None]
                dk = d[k][sl].float()
                inv = (1.0 / torch.where(dk.abs() < 1e-30,
                                         torch.where(dk < 0, -1e-30, 1e-30),
                                         dk))[:, None]
                t1 = (self.lo[None, :, k] - ok) * inv
                t2 = (self.hi[None, :, k] - ok) * inv
                tn = torch.maximum(tn, torch.minimum(t1, t2))
                tf = torch.minimum(tf, torch.maximum(t1, t2))
            cross = (tn <= tf) & (tf >= 0.0)
            if limit is not None:
                cross &= tn <= limit[sl].float()[:, None]
            nz = torch.nonzero(cross)
            nz[:, 0] += s
            out.append(nz)
        return torch.cat(out)

    def _tests(self, pairs, o, d, t_min, limit):
        """Yield (ray, chunk, (G, chunk) t, (G, chunk) hit) over groups of
        pairs."""
        c = self.chunk
        group = max(1, _PAIR_ELEMS // c)
        for s in range(0, pairs.shape[0], group):
            r, ch = pairs[s:s + group, 0], pairs[s:s + group, 1]
            a = _Rows(self.planes, None if self.n_chunks == 1 else ch)
            oo = tuple(x[r][:, None] for x in o)
            dd = tuple(x[r][:, None] for x in d)
            t_max = MISS if limit is None else limit[r][:, None]
            th, ok = wald(a, oo, dd, t_min, t_max)
            yield r, ch, th, ok

    def closest(self, o, d, t_min):
        """→ (t, (n, 16) rows in ``dt``): t = 3e38 and row 0 on a miss."""
        n = o[0].shape[0]
        dev = o[0].device
        pairs = self._pairs(o, d, None)
        ts, ids, rs = [], [], []
        c = self.chunk
        big = 1 << 62
        sid = self.scene_id.view(self.n_chunks, c)
        for r, ch, th, ok in self._tests(pairs, o, d, t_min, None):
            th = torch.where(ok, th.float(), np.inf)
            m = th.min(dim=1).values
            ts.append(m)
            ids.append(torch.where(th == m[:, None], sid[ch], big)
                       .min(dim=1).values)
            rs.append(r)
        best_t = torch.full((n,), MISS, dtype=torch.float32, device=dev)
        best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
        if rs:
            r, m, idx = torch.cat(rs), torch.cat(ts), torch.cat(ids)
            best_t = best_t.scatter_reduce(0, r, m, "amin")
            win = m == best_t[r]
            first = torch.full((n,), big, dtype=torch.int64, device=dev)
            first = first.scatter_reduce(0, r[win], idx[win], "amin")
            best_i = torch.where(first < big, first, 0)
        return best_t.to(self.dt), self.by_id[best_i]

    def occluded(self, o, d, limit, t_min):
        """→ bool: any hit in (t_min, limit)."""
        n = o[0].shape[0]
        occ = torch.zeros(n, dtype=torch.int64, device=o[0].device)
        pairs = self._pairs(o, d, limit)
        for r, _, _, ok in self._tests(pairs, o, d, t_min, limit):
            occ.scatter_reduce_(0, r, ok.any(dim=1).to(torch.int64), "amax")
        return occ > 0
