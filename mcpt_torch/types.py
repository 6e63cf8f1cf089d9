"""Core structure-of-arrays types as NamedTuples of torch tensors.

The port's counterpart of ``mcpt/types.py``: the same fields, shapes and
dtypes, held as tensors on an explicit ``device``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Material type codes — same values as the reference enum (objdef.h:58-67).
DIFFUSE = 1
GLOSSY = 2
TRANSPARENT = 3
LIGHT = 4

# Geometric epsilon for origin offsets (reference oclbasic.h:193 EPSILON=0.001f).
EPSILON = 1e-3


class Materials(NamedTuple):
    """SoA material table with the raw .mtl values (normalisation lives in the
    BSDF code, as in ``mcpt``)."""

    mtype: torch.Tensor  # (M,)  int32 — DIFFUSE/GLOSSY/TRANSPARENT/LIGHT
    kd: torch.Tensor  # (M, 3) f32 — diffuse reflectance
    ks: torch.Tensor  # (M, 3) f32 — specular reflectance (glossy)
    ka: torch.Tensor  # (M, 3) f32 — emission (LIGHT)
    ns: torch.Tensor  # (M,)  f32 — phong exponent
    ni: torch.Tensor  # (M,)  f32 — index of refraction

    @property
    def count(self) -> int:
        return self.mtype.shape[0]


class Geometry(NamedTuple):
    """Triangle soup with baked per-face data."""

    verts: torch.Tensor  # (N, 3, 3) f32 — triangle vertices
    normals: torch.Tensor  # (N, 3) f32 — geometric normals (unit)
    mat_id: torch.Tensor  # (N,) int32

    @property
    def count(self) -> int:
        return self.verts.shape[0]


class BVH(NamedTuple):
    """Flattened SoA binary BVH with ``mcpt``'s layout contract
    (``BVH/hlbvh.cpp:164-193``): 2N-1 nodes, internals [0, N-2], leaves
    [N-1, 2N-2], root 0, leaf ``left == right ==`` triangle id, parent of the
    root -1 (a single-triangle tree is one leaf node)."""

    bbmin: torch.Tensor  # (2N-1, 3) f32
    bbmax: torch.Tensor  # (2N-1, 3) f32
    left: torch.Tensor  # (2N-1,) int32 — child node id; for leaves: triangle id
    right: torch.Tensor  # (2N-1,) int32
    parent: torch.Tensor  # (2N-1,) int32 — -1 for the root

    @property
    def n_nodes(self) -> int:
        return self.left.shape[0]

    @property
    def n_tris(self) -> int:
        return (self.n_nodes + 1) // 2

    def to(self, device) -> "BVH":
        return BVH(*(t.to(device) for t in self))


class WaldTris(NamedTuple):
    """Unit-triangle affine transforms: for triangle i, ``A_i`` maps world
    space so the triangle becomes the unit triangle in the (u, v) plane at
    w = 0 (layout of ``mcpt.types.WaldTris``)."""

    w: torch.Tensor  # (3, T, 3) f32, w[k, t, j] = A[t, j, k]
    b: torch.Tensor  # (T, 3) f32 — affine offsets


class Scene(NamedTuple):
    geom: Geometry
    materials: Materials
    # the per-triangle LBVH (``BVH``), built for every scene, and the
    # clustered two-level BVH (``mcpt_torch.bvh.cluster.ClusterBVH``) past
    # 512 triangles, which the hybrid engine walks
    bvh: BVH | None = None
    # scale-aware epsilon, 1e-4 of the scene diagonal (0-d f32 tensor)
    eps: torch.Tensor | float = EPSILON
    wald: WaldTris | None = None
    clusters: object = None

    @property
    def n_tris(self) -> int:
        return self.geom.count


class Camera(NamedTuple):
    """Orthonormal camera basis (``mcpt.types.Camera``)."""

    position: torch.Tensor  # (3,)
    forward: torch.Tensor  # (3,) unit, towards lookat
    right: torch.Tensor  # (3,) unit
    up: torch.Tensor  # (3,) unit
    half_height: torch.Tensor  # () tan(fov/2) pinhole; world half-height ortho
    half_width: torch.Tensor  # () half_height * aspect
    is_ortho: torch.Tensor  # () f32, 1.0 = orthographic


class RayPool(NamedTuple):
    """Wavefront ray state, one entry per path (``mcpt.types.RayPool``)."""

    origin: torch.Tensor  # (R, 3) f32
    direction: torch.Tensor  # (R, 3) f32 unit
    throughput: torch.Tensor  # (R, 3) f32 — path weight so far
    radiance: torch.Tensor  # (R, 3) f32 — accumulated radiance
    pixel: torch.Tensor  # (R,) int32 — destination pixel id
    alive: torch.Tensor  # (R,) bool
    inside: torch.Tensor  # (R,) bool — inside a transparent medium

    @property
    def count(self) -> int:
        return self.origin.shape[0]


class Hit(NamedTuple):
    """Closest-hit record (``mcpt.types.Hit``)."""

    t: torch.Tensor  # (R,) f32 — inf on a miss
    tri: torch.Tensor  # (R,) int32 — -1 on a miss
    point: torch.Tensor  # (R, 3) f32
    normal: torch.Tensor  # (R, 3) f32 — geometric, not flipped to face the ray

    @property
    def valid(self) -> torch.Tensor:
        return self.tri >= 0


class Framebuffer(NamedTuple):
    """Progressive accumulation state: an exact (sum, count) pair divided at
    readout — an unbiased running mean."""

    sum: torch.Tensor  # (H*W, 3) f32 — Σ radiance samples
    count: torch.Tensor  # (H*W,) f32 — samples accumulated per pixel

    @property
    def mean(self) -> torch.Tensor:
        return self.sum / torch.clamp(self.count, min=1.0)[:, None]


def make_framebuffer(n_pixels: int, device) -> Framebuffer:
    return Framebuffer(
        sum=torch.zeros((n_pixels, 3), dtype=torch.float32, device=device),
        count=torch.zeros((n_pixels,), dtype=torch.float32, device=device),
    )


def _f32(x, device, shape):
    arr = np.asarray(x, np.float32).reshape(shape)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def materials_from_numpy(mtype, kd, ks, ka, ns, ni, device) -> Materials:
    return Materials(
        mtype=torch.from_numpy(
            np.asarray(mtype, np.int32).reshape(-1).copy()).to(device),
        kd=_f32(kd, device, (-1, 3)),
        ks=_f32(ks, device, (-1, 3)),
        ka=_f32(ka, device, (-1, 3)),
        ns=_f32(ns, device, (-1,)),
        ni=_f32(ni, device, (-1,)),
    )


def geometry_from_verts(verts, mat_id, device) -> Geometry:
    """Bake geometric normals from vertex winding (host numpy, as ``mcpt``)."""
    v = np.asarray(verts, np.float32).reshape(-1, 3, 3)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    length = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(length, 1e-20)
    return Geometry(
        verts=_f32(v, device, (-1, 3, 3)),
        normals=_f32(n, device, (-1, 3)),
        mat_id=torch.from_numpy(
            np.asarray(mat_id, np.int32).reshape(-1).copy()).to(device),
    )
