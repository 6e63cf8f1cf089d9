"""The open box field, 108,004 triangles: 9,000 random axis-aligned boxes
standing on a 240×240 ground under a 2-triangle sky light 60 above it.
Nothing closes the scene, so most paths leave it within a few bounces.
The boxes' centres, sizes and heights are drawn from
``np.random.default_rng(0)`` in that order; the camera looks down on the
field from (0, 25, 110)."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.shapes import (DIFFUSE, GLOSSY, LIGHT, box, quad,
                                     scene_dict)

N_BOXES = 9000
GROUND = 120.0  # half width of the ground
SKY = 150.0  # half width of the sky light, at height 60


def build() -> dict:
    rng = np.random.default_rng(0)
    g = GROUND
    tris: list = list(quad((-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g)))
    mat_id: list = [0, 0]
    centers = rng.uniform(-100, 100, (N_BOXES, 2))
    sizes = rng.uniform(0.4, 3.0, (N_BOXES, 3))
    heights = rng.uniform(0.5, 8.0, N_BOXES)
    for i in range(N_BOXES):
        cx, cz = centers[i]
        sx, _, sz = sizes[i]
        b = box((cx - sx, 0, cz - sz), (cx + sx, heights[i], cz + sz))
        tris += b
        mat_id += [1 + (i % 3)] * len(b)
    tris += quad((-SKY, 60, -SKY), (SKY, 60, -SKY), (SKY, 60, SKY),
                 (-SKY, 60, SKY))
    mat_id += [4, 4]

    mtype = [DIFFUSE, DIFFUSE, GLOSSY, DIFFUSE, LIGHT]
    kd = [[0.5, 0.5, 0.5], [0.7, 0.3, 0.2], [0.1, 0.1, 0.1],
          [0.2, 0.4, 0.7], [0, 0, 0]]
    ks = [[0, 0, 0], [0, 0, 0], [0.8, 0.8, 0.8], [0, 0, 0], [0, 0, 0]]
    ka = [[0, 0, 0]] * 4 + [[3.0, 3.0, 3.0]]
    ns = [0, 0, 60.0, 0, 0]
    ni = [1.0] * 5
    camera = dict(position=(0, 25, 110), lookat=(0, 2, 0), up=(0, 1, 0),
                  fov=50)
    return scene_dict(tris, mat_id, mtype, kd, ks, ka, ns, ni, camera)
