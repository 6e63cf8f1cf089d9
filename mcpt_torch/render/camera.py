"""Camera basis and the wavefront engine's primary rays (the port of
``mcpt/render/camera.py``).

Right-handed basis ``right = dir × up``, ``up = right × dir``; row 0 of the
image is the *bottom*.  The pinhole and orthographic cases follow the
reference (``auxiliary.cpp:20-71``, ``rayGenerator.cl:10-28``).  The kernel
engines make their primary rays themselves (``cam_ray`` in the megakernels,
``cluster_megakernel.camera_pool`` in the hybrid); ``generate_rays`` and
``generate_rays_for_pixels`` feed the wavefront engine, jittered by threefry
draws (``mcpt_torch.rng``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from mcpt_torch import rng
from mcpt_torch.config import CameraConfig
from mcpt_torch.types import Camera, RayPool


def make_camera(cfg: CameraConfig, ortho_height: float | None = None,
                device="cuda") -> Camera:
    """Build the orthonormal camera basis on the host, in float32 numpy as
    ``mcpt`` does, and place it on ``device`` (by default the card, where
    ``mcpt``'s lands on the accelerator; CPU callers pass ``"cpu"``).

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


def recip_f32(c) -> float:
    """1/c rounded in float32: what ``x / c`` multiplies by in ``mcpt``
    when ``c`` is a compile-time constant (XLA rewrites the division by a
    constant into a product with its reciprocal)."""
    return float(np.float32(1.0) / np.float32(c))


def generate_rays(camera: Camera, width: int, height: int,
                  key: rng.Key | None = None, jitter: bool = True) -> RayPool:
    """One primary ray per pixel, pixel id = y·W + x."""
    pix = torch.arange(width * height, dtype=torch.int32,
                       device=camera.position.device)
    return generate_rays_for_pixels(camera, width, height, pix, key=key,
                                    jitter=jitter)


def generate_rays_for_pixels(camera: Camera, width: int, height: int,
                             pix: torch.Tensor, key: rng.Key | None = None,
                             jitter: bool = True) -> RayPool:
    """Primary rays for the pixel ids ``pix`` in the order given
    (``mcpt/render/camera.py:131-185``): the jitter is
    ``uniform(key, (n, 2))`` over these lanes, so a tiled pool draws other
    jitter than an untiled one.  Without ``key`` (or ``jitter``) each ray
    passes through its pixel's corner."""
    n = pix.shape[0]
    dev = camera.position.device
    px = (pix % width).to(torch.float32)
    py = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    if jitter and key is not None:
        off = rng.uniform(key, (n, 2), dev)
        px = px + off[:, 0]
        py = py + off[:, 1]
    sx = px * recip_f32(width) - 0.5
    sy = py * recip_f32(height) - 0.5
    # pinhole (rayGenerator.cl:13-21) and orthographic (:23-27), blended
    span_x = (2.0 * sx * camera.half_width)[:, None] * camera.right[None, :]
    span_y = (2.0 * sy * camera.half_height)[:, None] * camera.up[None, :]
    d_pin = camera.forward[None, :] + span_x + span_y
    o_pin = camera.position.expand(n, 3)
    o_ort = camera.position[None, :] + span_x + span_y
    d_ort = camera.forward.expand(n, 3)
    w_ort = camera.is_ortho
    origin = o_pin * (1.0 - w_ort) + o_ort * w_ort
    direction = d_pin * (1.0 - w_ort) + d_ort * w_ort
    sq = direction * direction
    norm = torch.sqrt(sq[:, 0] + sq[:, 1] + sq[:, 2])
    direction = direction / norm[:, None]
    return RayPool(
        origin=origin.contiguous(),
        direction=direction.contiguous(),
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        pixel=pix.to(torch.int32),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        inside=torch.zeros((n,), dtype=torch.bool, device=dev),
    )
