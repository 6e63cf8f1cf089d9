#!/usr/bin/env python
"""Render the golden images (the port's ``tools/make_goldens.py``): each
scene of ``GOLDENS`` at 2048 spp with NEE+MIS, in 256-spp steps seeded
``1000 + s0``, through the port's dense megakernel (``render_mega``) or
hybrid (``render_hybrid``, no compaction, as ``mcpt``'s golden run has
none), written vertically flipped as ``<scene>.exr``.

These are the streams ``mcpt``'s golden runs drew, so the port's goldens
differ from the committed ``tests/goldens/*.exr`` by far less than two
independent renders' noise.  The committed goldens are ``mcpt``'s and stay
as they are: this tool writes to ``--out`` and refuses ``tests/goldens/``.

Usage:
    python -m mcpt_torch.make_goldens [SCENE ...] [--out DIR]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")

GOLDENS = [
    # (scene builder name, width, height, spp, max_depth, nee, mis, engine)
    ("cornell_box", 128, 128, 2048, 16, True, True, "mega"),
    ("veach_mis", 192, 128, 2048, 8, True, True, "mega"),
    ("quad_light_plane", 128, 128, 2048, 6, True, True, "mega"),
    # the large-BVH workload class (NEE from small emitters) through the
    # cluster engine
    ("diningroom", 160, 90, 2048, 8, True, True, "hybrid"),
]
STEP = 256  # spp a render call; step s0 is seeded 1000 + s0


def render_golden(name: str, width: int, height: int, spp: int,
                  max_depth: int, nee: bool, mis: bool, engine: str,
                  device="cuda") -> np.ndarray:
    """One ``GOLDENS`` entry → the (height, width, 3) float32 mean image,
    row 0 the framebuffer's first row (unflipped)."""
    import torch

    from mcpt_torch import scenes
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.kernels import megakernel as mk
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.scene import build_scene

    loaded, camcfg = getattr(scenes, name)()
    camcfg = dataclasses.replace(camcfg, resolution=(width, height))
    scene, lights = build_scene(loaded, device=device)
    cam = make_camera(camcfg, device=device)
    kw = dict(max_depth=max_depth, nee=nee, mis=mis)
    if engine == "hybrid":
        cms = cmk.build_cluster_megascene(scene, lights)

        def render_step(s0, n):
            return cmk.render_hybrid(cms, cam, width, height, spp=n,
                                     seed=1000 + s0, **kw)[0]
    else:
        mega = mk.build_megascene(scene, lights)

        def render_step(s0, n):
            return mk.render_mega(mega, cam, width, height, spp=n,
                                  seed=1000 + s0, **kw)[0]

    total = torch.zeros((width * height, 3), dtype=torch.float32,
                        device=device)
    for s0 in range(0, spp, STEP):
        total += render_step(s0, min(STEP, spp - s0))
    return (total.cpu().numpy() / spp).reshape(height, width, 3)


def make_golden(entry, out_dir: str, device="cuda",
                spp: int | None = None) -> str:
    """Render ``entry`` (a ``GOLDENS`` row; ``spp`` overrides its count),
    write ``<out_dir>/<scene>.exr`` flipped as the goldens are, print the
    tool's line → the path."""
    from mcpt_torch.io import image as im

    name, w, h, spp0, depth, nee, mis, engine = entry
    spp = spp0 if spp is None else spp
    t0 = time.time()
    img = render_golden(name, w, h, spp, depth, nee, mis, engine, device)
    path = os.path.join(out_dir, f"{name}.exr")
    im.write_exr(path, img[::-1])
    print(f"{name}: {w}x{h} @ {spp} spp in {time.time() - t0:.1f}s "
          f"mean {img.mean():.4f} -> {path}", flush=True)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scenes", nargs="*",
                    help="render only these GOLDENS scenes")
    ap.add_argument("--out", default=os.path.join(ROOT, "out", "goldens"),
                    help="output directory (never tests/goldens/)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the CUDA kernels, cpu the "
                         "plain PyTorch versions")
    args = ap.parse_args(argv)
    only = set(args.scenes)
    unknown = only - {g[0] for g in GOLDENS}
    if unknown:
        # fail fast: a typo must not silently render nothing and exit 0
        sys.exit(f"unknown scenes: {sorted(unknown)}")
    out = os.path.realpath(args.out)
    committed = os.path.realpath(GOLDEN_DIR)
    if out == committed or out.startswith(committed + os.sep):
        sys.exit(f"refusing to write into {GOLDEN_DIR}: the committed "
                 "goldens are mcpt's")
    os.makedirs(out, exist_ok=True)
    for entry in GOLDENS:
        if not only or entry[0] in only:
            make_golden(entry, out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
