"""What the reference works out from the raw scene itself: per-triangle
Wald transforms, normals and material rows, the NEE light table, the ray
offset ``eps`` and the camera basis.  numpy on the host, from the arrays
the benchmark generated; nothing here reads a table the program built.

The arithmetic follows the scene format's definitions (the Wald unit-
triangle transform with a float64 inverse, area-proportional light
picking, a pinhole camera with ``right = dir × up``), rounded to float32
where the program's tables are float32, so both sides start from the same
numbers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

LIGHT = 4


class Tables(NamedTuple):
    rows: np.ndarray  # (T, 16) f32: 0:9 A row-major, 9:12 b, 12:15 n, 15 mat
    verts: np.ndarray  # (T, 3, 3) f32
    matt: np.ndarray  # (M, 12) f32: kd, ks, ka, ns, ni, mtype
    lit: np.ndarray  # (L, 16) f32: v0, e1, e2, emission, normal, cdf
    n_lights: int
    total_light_area: float
    eps: float


class Camera(NamedTuple):
    sf: list  # 0:3 position, 3:6 forward, 6:9 right, 9:12 up, 12 half_w,
    #           13 half_h, 17 is_ortho — each an exact float32 value


def wald_rows(verts: np.ndarray) -> np.ndarray:
    """(T, 12) f32: the affine map p' = A (p - v0) onto the unit triangle
    (columns e1 | e2 | n inverted in float64), A[j, k] at 3·j + k, and
    b = -A v0.  A degenerate triangle never reports a hit (A = 0,
    b = (0, 0, 1))."""
    v = np.asarray(verts, np.float64).reshape(-1, 3, 3)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    m = np.stack([e1, e2, np.cross(e1, e2)], axis=-1)
    ok = np.abs(np.linalg.det(m)) > 1e-18
    a = np.linalg.inv(np.where(ok[:, None, None], m, np.eye(3)[None]))
    b = -np.einsum("tjk,tk->tj", a, v[:, 0])
    a = np.where(ok[:, None, None], a, 0.0)
    b = np.where(ok[:, None], b, np.array([0.0, 0.0, 1.0]))
    out = np.zeros((v.shape[0], 12), np.float32)
    out[:, 0:9] = np.asarray(a, np.float32).reshape(-1, 9)
    out[:, 9:12] = np.asarray(b, np.float32)
    return out


def build(scene: dict) -> Tables:
    verts = np.asarray(scene["verts"], np.float32).reshape(-1, 3, 3)
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    n = np.cross(e1, e2)
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    mat_id = np.asarray(scene["mat_id"]).reshape(-1)
    rows = np.zeros((verts.shape[0], 16), np.float32)
    rows[:, 0:12] = wald_rows(verts)
    rows[:, 12:15] = n
    rows[:, 15] = np.clip(mat_id, 0, None)

    mtype = np.asarray(scene["mtype"]).reshape(-1)
    matt = np.zeros((max(len(mtype), 1), 12), np.float32)
    matt[:, 0:3] = scene["kd"]
    matt[:, 3:6] = scene["ks"]
    matt[:, 6:9] = scene["ka"]
    matt[:, 9] = scene["ns"]
    matt[:, 10] = scene["ni"]
    matt[:, 11] = mtype

    ids = np.nonzero((mat_id >= 0)
                     & (mtype[np.clip(mat_id, 0, None)] == LIGHT))[0]
    lit = np.zeros((max(len(ids), 1), 16), np.float32)
    total = 0.0
    if len(ids):
        lv = verts[ids]
        area = 0.5 * np.linalg.norm(np.cross(lv[:, 1] - lv[:, 0],
                                             lv[:, 2] - lv[:, 0]), axis=1)
        total = float(area.sum())
        lit[:, 0:3] = lv[:, 0]
        lit[:, 3:6] = lv[:, 1] - lv[:, 0]
        lit[:, 6:9] = lv[:, 2] - lv[:, 0]
        lit[:, 9:12] = np.asarray(scene["ka"])[mat_id[ids]]
        lit[:, 12:15] = n[ids]
        lit[:, 15] = (np.cumsum(area) / max(total, 1e-30)).astype(np.float32)
    flat = verts.reshape(-1, 3)
    diag = float(np.linalg.norm(flat.max(axis=0) - flat.min(axis=0)))
    return Tables(rows=rows, verts=verts, matt=matt, lit=lit,
                  n_lights=len(ids),
                  total_light_area=float(np.float32(total)),
                  eps=float(np.float32(max(1e-4 * diag, 1e-6))))


def camera(cam: dict, width: int, height: int) -> Camera:
    """Pinhole basis in float32: forward = lookat - position, right =
    forward × up, up = right × forward, each normalised; half_h =
    tan(fov/2), half_w = half_h · W/H."""
    pos = np.asarray(cam["position"], np.float32)
    fwd = np.asarray(cam["lookat"], np.float32) - pos
    right = np.cross(fwd, np.asarray(cam["up"], np.float32))
    up = np.cross(right, fwd)

    def unit(v):
        return np.asarray(v / np.linalg.norm(v), np.float32)

    half_h = math.tan(math.radians(cam["fov"]) / 2.0)
    sf = [0.0] * 19
    sf[0:3] = pos.tolist()
    sf[3:6] = unit(fwd).tolist()
    sf[6:9] = unit(right).tolist()
    sf[9:12] = unit(up).tolist()
    sf[12] = float(np.float32(half_h * (width / height)))
    sf[13] = float(np.float32(half_h))
    return Camera(sf=[float(np.float32(x)) for x in sf])
