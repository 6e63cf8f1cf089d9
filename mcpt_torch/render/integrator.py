"""Render options and framebuffer accumulation (the port's counterpart of the
parts of ``mcpt/render/integrator.py`` that the megakernel path uses).

The wavefront integrator (``trace``, ``render_batch``, the resort and the
compaction) is ported with Slice 3.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from mcpt_torch.types import Framebuffer


class RenderOptions(NamedTuple):
    """Integrator options read by the CLI."""

    max_depth: int = 16
    nee: bool = False
    mis: bool = False
    russian_roulette: bool = False
    rr_start_depth: int = 3
    method: str = "auto"  # intersector: auto | brute | bvh


def accumulate(fb: Framebuffer, radiance_sum, spp: int = 1) -> Framebuffer:
    """Exact running (sum, count): every sample counts (unbiased mean)."""
    return Framebuffer(sum=fb.sum + radiance_sum, count=fb.count + float(spp))


def framebuffer_image(fb: Framebuffer, width: int, height: int) -> np.ndarray:
    """(H, W, 3) float32 mean radiance on the host, row 0 at the *bottom*
    (the reference framebuffer orientation; flip when writing images)."""
    return fb.mean.detach().cpu().numpy().reshape(height, width, 3)
