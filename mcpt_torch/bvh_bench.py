#!/usr/bin/env python
"""BVH construction-quality benchmark: the reference's testbvh/testall modes.

The port's counterpart of ``tools/bvh_bench.py`` (reference
``BVH::TEST::test`` / ``testall``, ``bvhtest.cpp:448-530,613-649``,
dispatched from ``main.cpp:12-19``): for each configured scene, build the
LBVH (on the host CPU), restructure it as ``bvhtype`` says, and print the
triangle count, the build times, SAH, EPO and, with a camera, LCV.
``treeletGPU`` and LCV run on ``--device`` (default ``cuda``); EPO runs the
host C++ walk.  ``render_cli`` dispatches a ``testbvh``/``testall`` config
entry here.

Usage:
    python -m mcpt_torch.bvh_bench [--config PATH] [--configid N]
        [--device cuda|cpu]
    python -m mcpt_torch.bvh_bench --scene procedural:cornell_box \\
        --bvhtype treelet
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def bench_model(loaded, bvhtype: str, camera_cfg, width: int, height: int,
                device="cuda") -> None:
    from mcpt_torch.bvh import lbvh, metrics, treelet, treelet_device
    from mcpt_torch.render import camera as camera_mod

    verts = loaded.verts
    print(f"  triangles: {len(verts)}")

    t0 = time.time()
    bvh = lbvh.build_lbvh(torch.from_numpy(np.asarray(verts, np.float32)))
    print(f"  LBVH build time: {(time.time() - t0) * 1e3:.2f} ms")

    if bvhtype == "treeletGPU":
        # the batched optimiser on the device; prints its own build time
        bvh = treelet_device.optimize_treelets_device(bvh.to(device),
                                                      verbose=True)
    elif bvhtype in ("treelet", "treelet_opt"):
        t0 = time.time()
        bvh = treelet.optimize_treelets(bvh)
        print(f"  treelet optimize time: {(time.time() - t0) * 1e3:.2f} ms")

    print(f"  SAH: {metrics.sah(bvh):.4f}")
    t0 = time.time()
    e = metrics.epo(bvh, verts)
    print(f"  EPO: {e:.4f}  ({time.time() - t0:.1f}s)")

    if camera_cfg is not None and camera_cfg.fov:
        cam = camera_mod.make_camera(camera_cfg, device=device)
        v = metrics.lcv(bvh, cam, width or 512, height or 512)
        print(f"  LCV: {v:.4f}")
    else:
        # testall entries carry no camera; the reference skips LCV then
        # (bvhtest.cpp:604)
        print("  LCV: skipped (no camera in config)")


def _load(cfg, name: str):
    from mcpt_torch import scenes as procedural
    from mcpt_torch.io.objloader import load_object

    if name.startswith("procedural:"):
        loaded, cam_default = getattr(procedural, name.split(":", 1)[1])()
        return loaded, cfg.camera or cam_default
    return load_object(cfg.directory, name), cfg.camera


def run_from_config(cfg, device="cuda") -> int:
    for name in cfg.objnames:
        print(f"model: {name} (bvhtype={cfg.bvhtype})")
        try:
            loaded, cam = _load(cfg, name)
        except FileNotFoundError as e:
            print(f"  SKIPPED: {e}")
            continue
        bench_model(loaded, cfg.bvhtype, cam, cfg.width, cfg.height, device)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="config.json")
    ap.add_argument("--configid", type=int, default=None)
    ap.add_argument("--scene", default=None,
                    help="benchmark a single scene instead of the config's")
    ap.add_argument("--bvhtype", default="hlbvh")
    ap.add_argument("--device", default="cuda",
                    help="torch device of treeletGPU and LCV (EPO runs on "
                         "the host)")
    args = ap.parse_args(argv)

    from mcpt_torch.config import Config, load_config

    if args.scene:
        cfg = Config(objname=args.scene, bvhtype=args.bvhtype, testbvh=True)
    else:
        cfg = load_config(args.config, args.configid)
    return run_from_config(cfg, args.device)


if __name__ == "__main__":
    sys.exit(main())
