"""The procedural dining room, 96,216 triangles: a closed room with two
ceiling light panels, a table with glass and metal tableware, six chairs and
a sideboard, every surface grid-tessellated so the scene is as deep as a
scanned interior."""

from __future__ import annotations

from benchmark.scenes.shapes import (DIFFUSE, GLOSSY, LIGHT, TRANSPARENT,
                                     box, box_tess, icosphere, quad,
                                     quad_tess, scene_dict)

TESS = 70  # room faces TESS×TESS, furniture TESS/8


def build() -> dict:
    order = ["wall", "wood", "lamp", "cloth", "metal", "glass", "dish"]
    names = {n: i for i, n in enumerate(order)}
    ft = max(2, TESS // 8)
    tris: list = []
    mat_id: list = []

    def add(t, m):
        tris.extend(t)
        mat_id.extend([names[m]] * len(t))

    # room shell x∈[-3,3], y∈[0,2.8], z∈[-4,4]
    add(quad_tess((-3, 0, -4), (3, 0, -4), (3, 0, 4), (-3, 0, 4), TESS),
        "wood")
    add(quad_tess((-3, 2.8, -4), (3, 2.8, -4), (3, 2.8, 4), (-3, 2.8, 4),
                  TESS), "wall")
    add(quad_tess((-3, 0, -4), (-3, 2.8, -4), (3, 2.8, -4), (3, 0, -4),
                  TESS), "wall")
    add(quad_tess((-3, 0, 4), (3, 0, 4), (3, 2.8, 4), (-3, 2.8, 4), TESS),
        "wall")
    add(quad_tess((-3, 0, -4), (-3, 0, 4), (-3, 2.8, 4), (-3, 2.8, -4),
                  TESS), "wall")
    add(quad_tess((3, 0, -4), (3, 2.8, -4), (3, 2.8, 4), (3, 0, 4), TESS),
        "wall")
    for zc in (-1.3, 1.3):  # two ceiling lamp panels
        add(quad((-0.6, 2.79, zc - 0.4), (0.6, 2.79, zc - 0.4),
                 (0.6, 2.79, zc + 0.4), (-0.6, 2.79, zc + 0.4)), "lamp")

    add(box_tess((-1.1, 0.72, -0.65), (1.1, 0.78, 0.65), ft), "wood")
    for lx in (-1.0, 1.0):
        for lz in (-0.55, 0.55):
            add(box_tess((lx - 0.04, 0, lz - 0.04),
                         (lx + 0.04, 0.72, lz + 0.04), ft), "wood")

    def chair(cx, cz, face_x):
        s = 0.22
        add(box_tess((cx - s, 0.42, cz - s), (cx + s, 0.47, cz + s), ft),
            "cloth")
        bx = cx + (s - 0.03) * face_x
        add(box_tess((bx - 0.03, 0.47, cz - s), (bx + 0.03, 0.95, cz + s),
                     ft), "cloth")
        for dx in (-s + 0.03, s - 0.03):
            for dz in (-s + 0.03, s - 0.03):
                add(box_tess((cx + dx - 0.02, 0, cz + dz - 0.02),
                             (cx + dx + 0.02, 0.42, cz + dz + 0.02), ft),
                    "wood")

    for cz in (-0.45, 0.45):
        chair(-1.55, cz, -1.0)
        chair(1.55, cz, 1.0)
    for cx in (-0.6, 0.6):
        chair(cx, -1.15, 0.0)

    add(box_tess((2.45, 0, -1.6), (2.95, 1.0, 1.6), ft), "wood")
    for sx, sz, m in ((-0.55, -0.25, "glass"), (0.5, 0.3, "glass"),
                      (-0.15, 0.35, "metal"), (0.25, -0.35, "metal")):
        sph = icosphere((sx, 0.78 + 0.09, sz), 0.09, subdiv=3)
        add([tuple(map(tuple, t)) for t in sph], m)
    for dx, dz in ((-0.7, 0.3), (0.0, -0.15), (0.75, -0.2)):
        add(box((dx - 0.1, 0.78, dz - 0.1), (dx + 0.1, 0.80, dz + 0.1)),
            "dish")

    mtype = [DIFFUSE, GLOSSY, LIGHT, DIFFUSE, GLOSSY, TRANSPARENT, DIFFUSE]
    kd = [[0.73, 0.70, 0.64], [0.32, 0.20, 0.10], [0, 0, 0],
          [0.55, 0.12, 0.12], [0.05, 0.05, 0.05], [0, 0, 0],
          [0.85, 0.85, 0.80]]
    ks = [[0, 0, 0], [0.25, 0.18, 0.10], [0, 0, 0], [0, 0, 0],
          [0.85, 0.86, 0.88], [0, 0, 0], [0, 0, 0]]
    ka = [[0, 0, 0], [0, 0, 0], [14.0, 13.0, 11.5], [0, 0, 0], [0, 0, 0],
          [0, 0, 0], [0, 0, 0]]
    ns = [0, 30.0, 0, 0, 200.0, 0, 0]
    ni = [1.0, 1.0, 1.0, 1.0, 1.0, 1.5, 1.0]
    camera = dict(position=(0.0, 1.5, 3.6), lookat=(0.0, 1.0, 0.0),
                  up=(0, 1, 0), fov=60.0)
    return scene_dict(tris, mat_id, mtype, kd, ks, ka, ns, ni, camera)
