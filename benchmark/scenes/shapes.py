"""Triangle-soup helpers for the benchmark's procedural scenes (numpy only).

The benchmark makes its inputs itself and hands the same arrays to the
program and to the plain reference.  These builders reproduce, value for
value, the port's procedural scenes (``mcpt_torch/scenes/procedural.py``),
so a cell renders the scene of the port's config entry; the benchmark's
tests hold the two equal.
"""

from __future__ import annotations

import numpy as np

# material types, as the scene format numbers them
DIFFUSE, GLOSSY, TRANSPARENT, LIGHT = 1, 2, 3, 4


def quad(a, b, c, d):
    """Two CCW triangles for quad a-b-c-d."""
    return [(a, b, c), (a, c, d)]


def box_faces(pmin, pmax):
    """The 6 quads (a, b, c, d) of an axis-aligned box, outward winding."""
    x0, y0, z0 = pmin
    x1, y1, z1 = pmax
    p = {(i, j, k): ((x0, x1)[i], (y0, y1)[j], (z0, z1)[k])
         for i in (0, 1) for j in (0, 1) for k in (0, 1)}
    return [
        (p[0, 0, 0], p[0, 1, 0], p[1, 1, 0], p[1, 0, 0]),  # z = z0
        (p[0, 0, 1], p[1, 0, 1], p[1, 1, 1], p[0, 1, 1]),  # z = z1
        (p[0, 0, 0], p[0, 0, 1], p[0, 1, 1], p[0, 1, 0]),  # x = x0
        (p[1, 0, 0], p[1, 1, 0], p[1, 1, 1], p[1, 0, 1]),  # x = x1
        (p[0, 0, 0], p[1, 0, 0], p[1, 0, 1], p[0, 0, 1]),  # y = y0
        (p[0, 1, 0], p[0, 1, 1], p[1, 1, 1], p[1, 1, 0]),  # y = y1
    ]


def box(pmin, pmax):
    """12 triangles of an axis-aligned box."""
    tris = []
    for f in box_faces(pmin, pmax):
        tris += quad(*f)
    return tris


def quad_tess(a, b, c, d, n: int):
    """Quad a-b-c-d split into an n×n bilinear grid (2·n² triangles), in
    float32: the point at (u, v) = (i/n, j/n) is (a(1-u) + bu)(1-v) +
    (d(1-u) + cu)v, each weight rounded to float32 first."""
    a, b, c, d = (np.asarray(p, np.float32) for p in (a, b, c, d))
    w = np.arange(n + 1) / n
    om, w32 = (1 - w).astype(np.float32), w.astype(np.float32)
    ab = a * om[:, None] + b * w32[:, None]
    dc = d * om[:, None] + c * w32[:, None]
    p = ab[:, None] * om[None, :, None] + dc[:, None] * w32[None, :, None]
    pa, pb = p[:-1, :-1], p[1:, :-1]
    pc, pd = p[1:, 1:], p[:-1, 1:]
    tris = np.stack([np.stack([pa, pb, pc], axis=2),
                     np.stack([pa, pc, pd], axis=2)], axis=2)
    return list(tris.reshape(-1, 3, 3))


def box_tess(pmin, pmax, n: int):
    """Box with each face tessellated n×n (12·n² triangles)."""
    tris = []
    for f in box_faces(pmin, pmax):
        tris += quad_tess(*f, n)
    return tris


def icosphere(center, radius, subdiv: int = 2) -> np.ndarray:
    """Triangulated sphere → (F, 3, 3) float32."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
                      (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
                      (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)],
                     np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdiv):
        new_faces = []
        cache: dict = {}
        vlist = list(verts)

        def mid(a, b):
            k = (min(a, b), max(a, b))
            if k not in cache:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                cache[k] = len(vlist)
                vlist.append(m)
            return cache[k]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        faces = new_faces
        verts = np.asarray(vlist)
    v = verts[np.asarray(faces)]
    return (np.asarray(v, np.float32) * radius
            + np.asarray(center, np.float32))


def scene_dict(tris, mat_id, mtype, kd, ks, ka, ns, ni, camera) -> dict:
    """The raw scene both sides receive: (T, 3, 3) vertices, per-triangle
    material ids, per-material arrays and the camera block."""
    return dict(
        verts=np.asarray(tris, np.float32).reshape(-1, 3, 3),
        mat_id=np.asarray(mat_id, np.int32).reshape(-1),
        mtype=np.asarray(mtype, np.int32).reshape(-1),
        kd=np.asarray(kd, np.float32).reshape(-1, 3),
        ks=np.asarray(ks, np.float32).reshape(-1, 3),
        ka=np.asarray(ka, np.float32).reshape(-1, 3),
        ns=np.asarray(ns, np.float32).reshape(-1),
        ni=np.asarray(ni, np.float32).reshape(-1),
        camera=camera,
    )
