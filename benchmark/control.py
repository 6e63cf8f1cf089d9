#!/usr/bin/env python3
"""The readings that the limits in ``limits/<workload>.json`` are set from,
at the cell's own size, on the card:

    python3 benchmark/control.py --workload NAME --seconds S --seeds A B C …

One process builds the program once, runs a window for each seed as
``run.py`` does (a cell on several cards as its rank 0, with the other
ranks started as ``run.py`` starts them), and then, with the program's
state freed, reads two sets of numbers for each against the plain
reference (float32) over the same samples and pixels:

- ``program``: the program's framebuffer and segments (the lower readings);
- ``control``: the plain reference computed in bfloat16, the precision
  below the float32 the configuration states, put in the program's place
  (the upper readings).  It renders the sampled pixels only, so its
  ``segs_gap`` compares the same paths.

Each seed prints one JSON line.  The benchmark's own runs never run this.
"""

import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import json  # noqa: E402

import numpy as np  # noqa: E402


def readings(cell, scene, seed, win, prog_rad, prog_count,
             device) -> dict:
    """The program's numbers and the bfloat16 reference's in its place,
    each against the float32 reference."""
    import torch

    from benchmark import check, harness
    from benchmark.reference import render as reference

    n_pixels = cell.cfg["width"] * cell.cfg["height"]
    n = len(win.seeds) * win.spp
    pixels = harness.sample_pixels(seed, n_pixels, int(cell.limits["pixels"]))
    full = cell.limits.get("full_step")
    j = harness.checked_step(seed, len(win.seeds)) if full else None

    def render(dt):
        ref = reference.prepare(scene, cell.cfg, device, dt)
        rad, _ = reference.render_pixels(*ref, pixels, win.seeds, win.spp)
        step = None
        if full:
            _, segs = reference.render_pixels(*ref, np.arange(n_pixels),
                                              [win.seeds[j]], win.spp)
            step = float(segs.sum())
        return rad, step

    rad32, step32 = render(torch.float32)
    out = dict(program=check.compare(
        prog_rad, prog_count, rad32, n,
        (win.seg_counts[j], step32) if full else None))
    rad16, step16 = render(torch.bfloat16)
    out["control"] = check.compare(
        rad16, np.full(len(pixels), float(n)), rad32, n,
        (step16, step32) if full else None)
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    from benchmark import harness, ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"no CUDA device for {args.workload}", file=sys.stderr)
        return 2
    # a cell on several cards runs as run.py runs it: rank 0 here
    world = (ranks.start(cell, args.seeds, args.seconds, "cuda",
                         harness.ROOT) if cell.chips > 1 else None)
    try:
        device = torch.device("cuda", 0) if world is None else world.device
        prog = harness.build(cell, device,
                             mesh=None if world is None else world.mesh)
        harness.warm_up(cell, prog, args.seeds[0], device)
        n_pixels = cell.cfg["width"] * cell.cfg["height"]
        runs = []
        for seed in args.seeds:
            win = harness.window(cell, prog, seed, args.seconds, False,
                                 device,
                                 None if world is None else world.agree)
            pixels = harness.sample_pixels(seed, n_pixels,
                                           int(cell.limits["pixels"]))
            runs.append((seed, win,
                         *harness.framebuffer_at(win.fb, pixels, device)))
            win.fb = None
        scene = prog.scene
        del prog
        if world is not None:
            world.finish()  # the other ranks exit before the references
    finally:
        if world is not None:
            world.close()
    for seed, win, prog_rad, prog_count in runs:
        t0 = time.perf_counter()
        out = dict(seed=seed, steps=len(win.times))
        out.update(readings(cell, scene, seed, win, prog_rad, prog_count,
                            device))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
