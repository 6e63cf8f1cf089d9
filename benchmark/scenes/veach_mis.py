"""The Veach MIS scene, 332 triangles: a diffuse floor and back wall, four
tilted Phong plates (Ns 5000, 800, 120, 20) and four equal-power sphere
lights of growing radius (80 triangles each).  Each plate is tilted by the
half-vector construction, so that it mirrors the row of lights into the
camera; the camera is the reference's ``veach_mis`` preset's."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.shapes import (DIFFUSE, GLOSSY, LIGHT, icosphere,
                                     quad, scene_dict)

PLATE_NS = (5000.0, 800.0, 120.0, 20.0)  # sharp → rough
LIGHT_RADII = (0.05, 0.15, 0.45, 1.35)
LIGHT_XS = (-4.5, -1.5, 1.5, 4.5)
LIGHT_KA = (901.0, 100.0, 11.1, 1.23)  # ∝ 1/radius²: equal power
CAMERA = np.array([0.0, 2.0, 15.0])
LIGHT_CENTER = np.array([0.0, 0.8, 0.0])


def plate(i: int) -> list:
    """Plate i's two triangles: 12 wide along x, 1.1 across its tilt, its
    normal the half vector between the light row and the camera."""
    center = np.array([0.0, -1.2 - 0.95 * i, 3.2 - 1.1 * i])
    to_l = LIGHT_CENTER - center
    to_c = CAMERA - center
    h = to_l / np.linalg.norm(to_l) + to_c / np.linalg.norm(to_c)
    n = h / np.linalg.norm(h)
    x = np.array([1.0, 0, 0])
    t = np.cross(x, n)
    t /= np.linalg.norm(t)
    w = 0.55
    return quad(tuple(center - 6 * x - w * t), tuple(center + 6 * x - w * t),
                tuple(center + 6 * x + w * t), tuple(center - 6 * x + w * t))


def build() -> dict:
    n_plates = len(PLATE_NS)
    tris: list = []
    mat_id: list = []

    def add(t, m):
        tris.extend(t)
        mat_id.extend([m] * len(t))

    add(quad((-15, -5, -5), (-15, -5, 15), (15, -5, 15), (15, -5, -5)), 0)
    add(quad((-15, -5, -6), (15, -5, -6), (15, 12, -6), (-15, 12, -6)), 0)
    for i in range(n_plates):
        add(plate(i), 1 + i)
    for i, (rad, x) in enumerate(zip(LIGHT_RADII, LIGHT_XS)):
        sph = icosphere((x, LIGHT_CENTER[1], LIGHT_CENTER[2]), rad, subdiv=1)
        add(sph.tolist(), 1 + n_plates + i)

    mtype = [DIFFUSE] + [GLOSSY] * n_plates + [LIGHT] * len(LIGHT_KA)
    kd = [[0.4] * 3] + [[0.03] * 3] * n_plates + [[0.0] * 3] * len(LIGHT_KA)
    ks = [[0.0] * 3] + [[0.9] * 3] * n_plates + [[0.0] * 3] * len(LIGHT_KA)
    ka = [[0.0] * 3] * (1 + n_plates) + [[k] * 3 for k in LIGHT_KA]
    ns = [0.0, *PLATE_NS] + [0.0] * len(LIGHT_KA)
    ni = [1.0] * len(mtype)
    camera = dict(position=(0, 2, 15), lookat=(0, -2, 2.5), up=(0, 1, 0),
                  fov=28)
    return scene_dict(tris, mat_id, mtype, kd, ks, ka, ns, ni, camera)
