"""Camera basis (the port's counterpart of ``mcpt/render/camera.py``'s
``make_camera``).

Right-handed basis ``right = dir × up``, ``up = right × dir``; row 0 of the
image is the *bottom*.  The pinhole and orthographic cases follow the
reference (``auxiliary.cpp:20-71``, ``rayGenerator.cl:10-28``).  Primary rays
are generated inside the megakernel (``cam_ray``) and by the hybrid engine
(``cluster_megakernel.camera_pool``); the wavefront ray generator is ported
with its engine.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from mcpt_torch.config import CameraConfig
from mcpt_torch.types import Camera


def make_camera(cfg: CameraConfig, ortho_height: float | None = None,
                device="cpu") -> Camera:
    """Build the orthonormal camera basis on the host, in float32 numpy as
    ``mcpt`` does, and place it on ``device``.

    ``cfg.ortho_height > 0`` (or the explicit kwarg) selects the orthographic
    camera; otherwise a pinhole with ``fov`` degrees vertical — ``fov <= 0``
    is rejected (every pixel would get the identical ray).
    """
    pos = np.asarray(cfg.position, np.float32)
    lookat = np.asarray(cfg.lookat, np.float32)
    up_in = np.asarray(cfg.up, np.float32)
    fwd = lookat - pos

    if ortho_height is None and cfg.ortho_height > 0.0:
        ortho_height = cfg.ortho_height
    is_ortho = ortho_height is not None
    if not is_ortho and cfg.fov <= 0.0:
        raise ValueError(
            f"fov must be > 0 for the perspective camera (got {cfg.fov}); "
            "set camera.ortho_height > 0 for the orthographic camera"
        )
    if not is_ortho:
        right = np.cross(fwd, up_in)
        up = np.cross(right, fwd)
    else:
        # ortho branch orthogonalizes up against fwd (auxiliary.cpp:53-61)
        up = up_in - (up_in @ fwd) / (fwd @ fwd) * fwd
        right = np.cross(fwd, up)

    def vec(v):
        return torch.from_numpy(
            np.ascontiguousarray(v / np.linalg.norm(v), np.float32)).to(device)

    def scalar(x):
        return torch.tensor(np.float32(x), device=device)

    # pinhole: half_height = tan(fov/2); ortho: ±ortho_height/2 origin span
    half_h = (math.tan(math.radians(cfg.fov) / 2.0) if not is_ortho
              else float(ortho_height) / 2.0)
    w, h = cfg.resolution
    aspect = (w / h) if h else 1.0
    return Camera(
        position=torch.from_numpy(pos.copy()).to(device),
        forward=vec(fwd),
        right=vec(right),
        up=vec(up),
        half_height=scalar(half_h),
        half_width=scalar(half_h * aspect),
        is_ortho=scalar(1.0 if is_ortho else 0.0),
    )


@functools.lru_cache(maxsize=32)
def tile_order(width: int, height: int, block: int = 1024):
    """Pixel permutation that makes consecutive ``block``-ray groups
    square-ish screen tiles (≈√block × √block) instead of scanline strips
    (``mcpt/render/camera.py:86-109``).  Returns ``(perm, inv_perm)`` as
    numpy int32: rays are generated for pixels ``perm`` and the image is
    recovered as ``radiance[inv_perm]``.  Cached: callers must not write to
    the arrays."""
    tx = 1 << ((block.bit_length() - 1) // 2)
    ty = block // tx
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    n_tx = (width + tx - 1) // tx
    key = ((yy // ty) * n_tx + (xx // tx)) * (tx * ty) + (yy % ty) * tx + (
        xx % tx)
    perm = np.argsort(key.reshape(-1), kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv
