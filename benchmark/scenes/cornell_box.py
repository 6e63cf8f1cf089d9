"""The Cornell box, 36 triangles, with the reference's ``cbox.mtl``
palette: a silver (glossy) tall box and a glass short box."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.shapes import (DIFFUSE, GLOSSY, LIGHT, TRANSPARENT,
                                     box, quad, scene_dict)

# Scene/cbox/cbox.mtl, in the order the triangles name them
MATERIALS = (
    ("white", DIFFUSE, dict(Kd=(0.85, 0.75, 0.65))),
    ("red", DIFFUSE, dict(Kd=(0.95, 0.05, 0.05))),
    ("blue", DIFFUSE, dict(Kd=(0.05, 0.05, 0.95))),
    ("light", LIGHT, dict(Ka=(10.0, 10.0, 10.0))),
    ("silver", GLOSSY, dict(Kd=(0.77, 0.79, 0.73), Ks=(0.97, 0.99, 0.93),
                            Ns=98.0)),
    ("glass", TRANSPARENT, dict(Ni=1.5)),
)


def build() -> dict:
    names = {n: i for i, (n, _, _) in enumerate(MATERIALS)}
    tris: list = []
    mat_id: list = []

    def add(t, m):
        tris.extend(t)
        mat_id.extend([names[m]] * len(t))

    add(quad((552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2)),
        "white")  # floor
    add(quad((556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2),
             (0, 548.8, 0)), "white")  # ceiling
    add(quad((549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2),
             (556, 548.8, 559.2)), "white")  # back
    add(quad((552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2),
             (556, 548.8, 0)), "red")
    add(quad((0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2)),
        "blue")
    add(quad((343, 548.75, 227), (343, 548.75, 332), (213, 548.75, 332),
             (213, 548.75, 227)), "light")
    add(box((265, 0, 296), (430, 330, 456)), "silver")
    add(box((130, 0, 65), (295, 165, 225)), "glass")

    m = len(MATERIALS)
    mtype = np.array([t for _, t, _ in MATERIALS], np.int32)
    kd, ks, ka = (np.zeros((m, 3), np.float32) for _ in range(3))
    ns, ni = np.zeros(m, np.float32), np.ones(m, np.float32)
    for i, (_, _, d) in enumerate(MATERIALS):
        kd[i] = d.get("Kd", (0, 0, 0))
        ks[i] = d.get("Ks", (0, 0, 0))
        ka[i] = d.get("Ka", (0, 0, 0))
        ns[i] = d.get("Ns", 0.0)
        ni[i] = d.get("Ni", 1.0)
    camera = dict(position=(278, 273, -800), lookat=(278, 273, -799),
                  up=(0, 1, 0), fov=39.3077)
    return scene_dict(tris, mat_id, mtype, kd, ks, ka, ns, ni, camera)
