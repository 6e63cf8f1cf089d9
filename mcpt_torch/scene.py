"""Scene assembly: geometry + materials + Wald transforms + light table +
LBVH + cluster BVH.

The port's counterpart of ``mcpt/scene.py``: per-triangle Wald transforms,
normals and material ids (the dense megakernel's tables), the
emissive-triangle light table, the scale-aware epsilon, and the acceleration
structures the hybrid engine walks.  All of it is built on the host (numpy
and CPU tensors); the results land on the caller's ``device``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcpt_torch import types
from mcpt_torch.io.objloader import LoadedObject
from mcpt_torch.types import Scene, WaldTris

_BVHTYPES = ("", "hlbvh", "lbvh", "treelet", "treelet_opt", "treeletGPU")


class Lights(NamedTuple):
    """Emissive-triangle table for next-event estimation (area-uniform)."""

    tri: torch.Tensor  # (L,) int32 triangle ids
    cdf: torch.Tensor  # (L,) f32 cumulative area distribution (last == 1)
    emission: torch.Tensor  # (L, 3) f32
    total_area: torch.Tensor  # () f32

    @property
    def count(self) -> int:
        return self.tri.shape[0]


def build_lights(verts: np.ndarray, mat_id: np.ndarray, mtype: np.ndarray,
                 ka: np.ndarray, device) -> Lights:
    v = np.asarray(verts, np.float32).reshape(-1, 3, 3)
    mat_id = np.asarray(mat_id).reshape(-1)
    valid = mat_id >= 0
    is_light = np.zeros(v.shape[0], bool)
    is_light[valid] = np.asarray(mtype)[mat_id[valid]] == types.LIGHT
    ids = np.nonzero(is_light)[0].astype(np.int32)
    if len(ids) == 0:
        return Lights(
            tri=torch.zeros((0,), dtype=torch.int32, device=device),
            cdf=torch.zeros((0,), dtype=torch.float32, device=device),
            emission=torch.zeros((0, 3), dtype=torch.float32, device=device),
            total_area=torch.tensor(0.0, dtype=torch.float32, device=device),
        )
    lv = v[ids]
    areas = 0.5 * np.linalg.norm(
        np.cross(lv[:, 1] - lv[:, 0], lv[:, 2] - lv[:, 0]), axis=1
    )
    total = float(areas.sum())
    cdf = np.cumsum(areas) / max(total, 1e-30)
    emission = np.asarray(ka)[mat_id[ids]]
    return Lights(
        tri=torch.from_numpy(ids).to(device),
        cdf=torch.from_numpy(cdf.astype(np.float32)).to(device),
        emission=torch.from_numpy(
            np.asarray(emission, np.float32).reshape(-1, 3)).to(device),
        total_area=torch.tensor(np.float32(total), device=device),
    )


def build_wald(verts: np.ndarray, device) -> WaldTris:
    """Per-triangle unit-triangle affine transforms (host, float64 inverse).
    Degenerate triangles get a transform that never reports a hit
    (d'_w = 0 ⇒ t = -inf)."""
    v = np.asarray(verts, np.float64).reshape(-1, 3, 3)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    m = np.stack([e1, e2, n], axis=-1)  # (T, 3, 3), columns e1|e2|n
    det = np.linalg.det(m)
    ok = np.abs(det) > 1e-18
    m_safe = np.where(ok[:, None, None], m, np.eye(3)[None])
    a = np.linalg.inv(m_safe)  # (T, 3, 3): p' = A (p - v0)
    b = -np.einsum("tjk,tk->tj", a, v[:, 0])  # (T, 3)
    a = np.where(ok[:, None, None], a, 0.0)
    b = np.where(ok[:, None], b, np.array([0.0, 0.0, 1.0]))
    w = np.transpose(a, (2, 0, 1))  # w[k, t, j] = A[t, j, k]
    return WaldTris(
        w=torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(device),
        b=torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(device),
    )


def build_scene(loaded: LoadedObject, bvhtype: str = "hlbvh",
                device="cuda"):
    """LoadedObject → (Scene, Lights) on ``device`` (``mcpt/scene.py:94``),
    by default the card, where ``mcpt``'s arrays land on the accelerator;
    CPU callers pass ``device="cpu"``.

    Builds the Wald transforms, normals, material ids, the light table,
    ``eps = max(1e-4·diag, 1e-6)``, the LBVH of every scene (on CPU tensors,
    as ``mcpt`` builds on its CPU backend) and, past 512 triangles, the
    cluster BVH.  Two clusterings are planned and the one with the lower
    top-tree SAH is built: fixed Morton chunks, and the DP cut of a
    treelet-optimised copy of the LBVH.

    ``bvhtype``: ``hlbvh``/``lbvh``/``""`` keep the LBVH, ``treelet`` (or
    ``treelet_opt``) restructures it with the C++ treelet optimiser,
    ``treeletGPU`` with the batched treelet DP on ``device``
    (``bvh.treelet_device``, ``mcpt/scene.py:122-127``).
    """
    from mcpt_torch.bvh import cluster as cluster_mod
    from mcpt_torch.bvh import lbvh as lbvh_mod
    from mcpt_torch.bvh import treelet as treelet_mod
    from mcpt_torch.bvh import treelet_device

    if bvhtype not in _BVHTYPES:
        raise ValueError(f"unknown bvhtype {bvhtype!r}")
    geom, mats = loaded.to_device(device)
    verts = np.asarray(loaded.verts, np.float32).reshape(-1, 3, 3)
    bvh = lbvh_mod.build_lbvh(torch.from_numpy(verts))
    if bvhtype in ("treelet", "treelet_opt"):
        bvh = treelet_mod.optimize_treelets(bvh)
    elif bvhtype == "treeletGPU":
        bvh = treelet_device.optimize_treelets_device(bvh.to(device),
                                                      verbose=True)
    lights = build_lights(loaded.verts, loaded.mat_id, loaded.mtype,
                          loaded.ka, device)
    v = loaded.verts.reshape(-1, 3)
    diag = float(np.linalg.norm(v.max(axis=0) - v.min(axis=0)))
    clusters = None
    if geom.count > 512:
        nrm = geom.normals.cpu().numpy()
        p_morton = cluster_mod.plan_clusters(verts)
        # the DP cut is planned on a treelet-optimised copy (tighter
        # subtrees); scene.bvh keeps the configured bvhtype
        plan_bvh = bvh
        if bvhtype in ("", "hlbvh", "lbvh"):
            plan_bvh = treelet_mod.optimize_treelets(bvh)
        p_cut = cluster_mod.plan_clusters(verts, bvh=plan_bvh, dp=True)
        best = (p_morton if cluster_mod.plan_sah(p_morton)
                <= cluster_mod.plan_sah(p_cut) else p_cut)
        clusters = cluster_mod.build_clusters(verts, nrm, loaded.mat_id,
                                              plan=best, device=device)
    scene = Scene(
        geom=geom, materials=mats, bvh=bvh.to(device),
        eps=torch.tensor(np.float32(max(1e-4 * diag, 1e-6)), device=device),
        wald=build_wald(loaded.verts, device),
        clusters=clusters,
    )
    return scene, lights


def loaded_from_arrays(verts, mat_id, mtype, kd, ks, ka, ns, ni,
                       names=None) -> LoadedObject:
    """Convenience for procedural scenes and tests."""
    return LoadedObject(
        verts=np.asarray(verts, np.float32).reshape(-1, 3, 3),
        mat_id=np.asarray(mat_id, np.int32).reshape(-1),
        mtype=np.asarray(mtype, np.int32).reshape(-1),
        kd=np.asarray(kd, np.float32).reshape(-1, 3),
        ks=np.asarray(ks, np.float32).reshape(-1, 3),
        ka=np.asarray(ka, np.float32).reshape(-1, 3),
        ns=np.asarray(ns, np.float32).reshape(-1),
        ni=np.asarray(ni, np.float32).reshape(-1),
        mat_names=list(names or []),
    )
