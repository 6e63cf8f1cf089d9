#!/usr/bin/env python
"""High-spp precision gate of the hybrid engine against the goldens (the
port's ``tools/validate_hybrid.py``), on the card by default.

Renders cbox and diningroom at 1024 spp through ``render_hybrid`` (kernel
2, the coherence re-sort and the pool compaction, with the caps of the
wavefront pilot ``integrator.measure_schedule``, as ``mcpt`` takes them)
in 64-spp batches seeded ``1000 + s0``, and gates the rel-RMSE against the
committed 2048-spp goldens at the measured-noise level.  cbox has no
cluster BVH from ``build_scene``; it gets Morton-chunk clusters
(``bvh.cluster.build_clusters``), as ``mcpt``'s run does.

Usage:
    python -m mcpt_torch.validate_hybrid [--device cuda|cpu]

Prints one line per scene and exits with the number of failed gates.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from mcpt_torch.make_goldens import GOLDEN_DIR

# (scene, W, H, spp, depth, gate) — W/H must match the committed golden.
# Gates: combined MC noise of (test, golden) renders × ~1.4 headroom.
#   cbox: 16-spp noise ≈ 0.11 ⇒ 1024-spp ≈ 1.4%, golden 2048 ≈ 1.0%,
#         combined ≈ 1.7% ⇒ gate 2.5%.
#   diningroom: 8-spp noise ≈ 0.30 ⇒ 1024-spp ≈ 2.7%, golden ≈ 1.9%,
#         combined ≈ 3.3% ⇒ gate 4.5%.
GATES = [
    ("cornell_box", 128, 128, 1024, 16, 0.025),
    ("diningroom", 160, 90, 1024, 8, 0.045),
]
BATCH = 64  # spp a render call: bounded pool memory, a seed per batch


def validate(name: str, width: int, height: int, spp: int, depth: int,
             tol: float, device="cuda") -> bool:
    """One ``GATES`` row through the hybrid on ``device``: print the pilot's
    caps and the scene's line → whether the rel-RMSE is under ``tol``."""
    import torch

    from mcpt_torch import scenes
    from mcpt_torch.bvh import cluster as cluster_mod
    from mcpt_torch.compare import compare
    from mcpt_torch.io import image as im
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.render import integrator as integ
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.scene import build_scene

    golden = im.read_exr_rgb(os.path.join(GOLDEN_DIR, f"{name}.exr"))[::-1]
    loaded, camcfg = getattr(scenes, name)()
    camcfg = dataclasses.replace(camcfg, resolution=(width, height))
    scene, lights = build_scene(loaded, device=device)
    if scene.clusters is None:
        # small scenes get no cluster BVH from build_scene; the hybrid
        # still runs on a Morton-chunk clustering
        verts = np.asarray(loaded.verts, np.float32).reshape(-1, 3, 3)
        scene = scene._replace(clusters=cluster_mod.build_clusters(
            verts, scene.geom.normals.cpu().numpy(), loaded.mat_id,
            cluster_mod.plan_clusters(verts), device=device))
    cam = make_camera(camcfg, device=device)
    cms = cmk.build_cluster_megascene(scene, lights)
    sched = integ.measure_schedule(
        scene, lights, cam,
        integ.RenderOptions(max_depth=depth, nee=True, mis=True,
                            method="bvh"))
    print(f"{name}: pool caps {sched} from the wavefront pilot "
          "(integrator.measure_schedule, method bvh, 128x128, 1 spp)",
          flush=True)
    t0 = time.time()
    acc = np.zeros((width * height, 3), np.float64)
    segs = 0.0
    for s0 in range(0, spp, BATCH):
        rad, seg = cmk.render_hybrid(
            cms, cam, width, height, spp=min(BATCH, spp - s0),
            seed=1000 + s0, max_depth=depth, nee=True, mis=True,
            compact=sched)
        acc += rad.cpu().numpy().astype(np.float64)
        segs += float(seg)
    img = (acc / spp).reshape(height, width, 3)
    dt = time.time() - t0
    stats = compare(img, golden.astype(np.float64))
    ok = stats["rel_rmse"] < tol
    print(f"{name:12s} {width}x{height} spp={spp} depth={depth} "
          f"rel_rmse={stats['rel_rmse']:.4f} (gate {tol}) "
          f"mean={img.mean():.4f} golden_mean={golden.mean():.4f} "
          f"{segs / dt / 1e6:6.2f} Mrays/s {dt:6.1f}s "
          f"{'OK' if ok else 'FAIL'} | device={torch.device(device)}",
          flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the CUDA kernels, cpu the "
                         "plain PyTorch versions (slow)")
    args = ap.parse_args(argv)
    return sum(not validate(*gate, device=args.device) for gate in GATES)


if __name__ == "__main__":
    sys.exit(main())
