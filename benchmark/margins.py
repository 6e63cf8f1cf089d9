#!/usr/bin/env python3
"""Whether the reference check can judge a hybrid cell, at the cell's own
size, on the card:

    python3 benchmark/margins.py --workload NAME --seeds A B C …

The plain reference (``benchmark/reference/``) renders whole paths and does
not model the hybrid's compaction roulette, which culls live lanes only
where more live than 97% of the next pool's lanes.  So the check stands
only if, at every shrink of the pool under the pilot's caps, the live
lanes fit: then the roulette keeps each with p = 1.

One process builds the cell's program and its pilot as ``run.py`` does,
renders one step a seed (the cell's samples a step, the window's first
step seed) and prints a JSON line a seed: the pool's rows at each bounce,
the live lanes after each bounce, and at each shrink the live lanes over
97% of the next pool's lanes (p = 1 where that is at most 1).  The
benchmark's own runs never run this.
"""

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import json  # noqa: E402


def main(argv=None) -> int:
    import argparse

    import torch

    from benchmark import harness
    from benchmark.engines.program import build_inputs, step_kwargs

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if cell.traffic["engine"] != "hybrid":
        print(f"{args.workload}: not a one-card hybrid cell", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print(f"no CUDA device for {args.workload}", file=sys.stderr)
        return 2
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.render import integrator as integ

    device = torch.device("cuda", 0)
    cfg, spp = cell.cfg, int(cell.traffic["spp_per_step"])
    prog_scene, lights, cam = build_inputs(cell.scene.build(), cfg, device)
    cms = cmk.build_cluster_megascene(prog_scene, lights)
    i = cfg["integrator"]
    caps = integ.measure_hybrid_schedule(cms, cam, integ.RenderOptions(
        max_depth=cfg["maxdepth"], nee=i["nee"], mis=i["mis"],
        russian_roulette=i["russian_roulette"],
        rr_start_depth=i["rr_start_depth"]))
    w, h = cfg["width"], cfg["height"]
    n_rays = w * h * spp
    rows = cmk._compaction_schedule(-(-n_rays // cmk.BLKT) * cmk.SUBT,
                                    cfg["maxdepth"], caps)
    shrinks = [d for d in range(len(rows) - 1) if rows[d + 1] < rows[d]]
    ok = True
    for seed in args.seeds:
        live: list = []
        cmk._run_hybrid(cms, cam, w, h, spp, harness.step_seed(seed, spp, 0),
                        live=live, **dict(step_kwargs(cfg), compact=caps))
        lanes = [round(x * n_rays) for x in live]
        ratio = {d: lanes[d] / (0.97 * rows[d + 1] * 128) for d in shrinks}
        ok &= all(r <= 1.0 for r in ratio.values())
        print(json.dumps(dict(
            workload=args.workload, seed=seed, caps=caps,
            key_mode=cmk.resolve_key_mode("auto", caps), rows=rows,
            lanes_a_step=sum(rows) * 128, live=lanes,
            shrinks={str(d): round(r, 4) for d, r in ratio.items()},
            p_one=all(r <= 1.0 for r in ratio.values()))), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
