#!/usr/bin/env python
"""Independent wavefront cross-check of the diningroom golden (the port's
``tools/crosscheck_wavefront.py``), on the card by default.

``mcpt``'s hybrid rendered the committed diningroom golden, so
``validate_hybrid``'s diningroom row is a self-consistency gate: a bias of
the hybrid would cancel.  This renders the same crop through the wavefront
integrator (``integrator.render``) and gates the rel-RMSE against the golden
at the measured-noise level.

It passes ``method="bvh"``, the batched stack walk of the binary LBVH in
``render/traverse.py``, explicitly.  The wavefront's ``auto`` intersector on
a clustered scene on CUDA is ``cluster``, kernel 4, and kernel 4 shares its
walk (``csrc/cluster_walk.cuh``) with kernel 2, the hybrid's kernel.  The
BVH walk shares no intersector, RNG stream (threefry keys, not the
counter hash), sort or compaction with the hybrid, so agreement means two
independent estimators converge to the same image.

Usage:
    python -m mcpt_torch.crosscheck_wavefront [--device cuda|cpu]

Exits 0 when the gate holds, 1 when it fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from mcpt_torch.make_goldens import GOLDEN_DIR

# Same crop/depth as validate_hybrid's diningroom row; same noise model:
# 1024-spp wavefront ≈ 2.7%, 2048-spp golden ≈ 1.9%, combined ≈ 3.3%
# ⇒ gate 4.5% (×1.4 headroom).
NAME, W, H, SPP, DEPTH, TOL = "diningroom", 160, 90, 1024, 8, 0.045
SEED, SPP_PER_STEP = 7, 64


def crosscheck(device="cuda", spp: int = SPP) -> bool:
    """Render the golden's crop at ``spp`` through the wavefront with the
    BVH walk on ``device``, print the tool's line → whether the rel-RMSE is
    under ``TOL``."""
    import torch

    from mcpt_torch import scenes
    from mcpt_torch.compare import compare
    from mcpt_torch.io import image as im
    from mcpt_torch.render import integrator as integ
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.scene import build_scene

    golden = im.read_exr_rgb(os.path.join(GOLDEN_DIR, f"{NAME}.exr"))[::-1]
    loaded, camcfg = getattr(scenes, NAME)()
    camcfg = dataclasses.replace(camcfg, resolution=(W, H))
    scene, lights = build_scene(loaded, device=device)
    cam = make_camera(camcfg, device=device)
    opts = integ.RenderOptions(max_depth=DEPTH, nee=True, mis=True,
                               method="bvh")

    t0 = time.time()
    fb = integ.render(scene, lights, cam, W, H, opts, spp=spp, seed=SEED,
                      spp_per_step=SPP_PER_STEP)
    img = np.asarray(integ.framebuffer_image(fb, W, H), np.float64)
    dt = time.time() - t0

    stats = compare(img, golden.astype(np.float64))
    ok = stats["rel_rmse"] < TOL
    print(f"{NAME:12s} {W}x{H} spp={spp} depth={DEPTH} wavefront(method=bvh) "
          f"rel_rmse={stats['rel_rmse']:.4f} (gate {TOL}) "
          f"mean={img.mean():.4f} golden_mean={golden.mean():.4f} "
          f"{dt:6.1f}s {'OK' if ok else 'FAIL'} | "
          f"device={torch.device(device)}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs on the card, cpu on the "
                         "host (slow)")
    args = ap.parse_args(argv)
    return 0 if crosscheck(args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
