"""The Cornell box with a tessellated white box (588 triangles) in it, and
every box raised off the floor: 624 triangles, past the 512 at which the
port builds a cluster BVH (so the hybrid runs on it), and no face
coplanar with another (the cluster walk and the reference order equal hits
differently)."""

import numpy as np

from benchmark.scenes import cornell_box
from benchmark.scenes.shapes import box_tess


def build() -> dict:
    scene = cornell_box.build()
    verts = scene["verts"].copy()
    verts[-24:, :, 1] += np.float32(7.5)  # the silver and the glass box
    extra = np.asarray(box_tess((60, 20, 300), (200, 140, 440), 7),
                       np.float32)
    scene["verts"] = np.concatenate([verts, extra])
    scene["mat_id"] = np.concatenate(
        [scene["mat_id"], np.zeros(len(extra), np.int32)])
    return scene
