"""Render options, framebuffer accumulation and the hybrid engine's pilot
(the port's counterpart of the parts of ``mcpt/render/integrator.py`` that
the megakernel and hybrid paths use).

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


def measure_schedule(cms, cam, opts: RenderOptions) -> tuple:
    """The port's pilot: per-depth live shares → a compaction schedule for
    the hybrid engine (``render_hybrid(compact=...)``).

    ``mcpt``'s pilot (``integrator.py:437-470``) runs its wavefront engine
    with threefry, which is not ported; this one runs the port's own hybrid
    at 128×128, 1 spp, seed 0, without compaction, and records the live
    share of the rays after each bounce but the last.  NEE is off: it adds
    radiance and never decides a path's life.  The caps then follow
    ``mcpt``'s rule: share × 1.35, at least 1/64, rounded up to 1/64, never
    rising.  They differ from ``mcpt``'s caps, and stay unbiased: a
    cap only decides how many paths the Bernoulli roulette keeps."""
    from mcpt_torch.kernels import cluster_megakernel as cmk

    fracs = []
    cmk._run_hybrid(cms, cam, 128, 128, 1, 0, max_depth=opts.max_depth,
                    rr=opts.russian_roulette, rr_start=opts.rr_start_depth,
                    key_mode="cell", live=fracs)
    sched = []
    prev = 1.0
    for f in fracs:
        capped = min(prev, max(f * 1.35, 1.0 / 64.0))
        capped = min(1.0, (int(capped * 64) + 1) / 64.0)
        capped = min(prev, capped)
        sched.append(capped)
        prev = capped
    return tuple(sched)
