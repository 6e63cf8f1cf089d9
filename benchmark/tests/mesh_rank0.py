#!/usr/bin/env python3
"""Rank 0 of a benchmark cell on several ranks, without ``run.py``'s look
for a card each: on the CPU (gloo) for the CPU tests, or with ``--device
cuda`` as ranks that share the cards there are (gloo too), a rehearsal of
the plumbing on one card.

    python3 benchmark/tests/mesh_rank0.py ROOT WORKLOAD SEED SECONDS \
        [--trace] [--steps OUT.npz] [--device cuda]

``ROOT`` is a checkout holding the cell's files; ``--steps`` writes rank
0's step seeds and each step's summed radiance (the mesh's) to ``OUT.npz``.
Prints the result line last, as ``run.py`` does.
"""

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])

import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    import argparse

    from benchmark import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("workload")
    ap.add_argument("seed", type=int)
    ap.add_argument("seconds", type=float)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--steps")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    steps = []

    def record(step):
        def wrapped(seed, spp):
            rad, segs = step(seed, spp)
            steps.append((seed, rad.cpu().numpy()))
            return rad, segs
        return wrapped

    cell = harness.load_cell(args.workload, Path(args.root))
    result, lines = harness.run_ranks(cell, args.seed, args.seconds,
                                      args.trace, args.device,
                                      time.perf_counter(),
                                      root=Path(args.root),
                                      wrap_step=record if args.steps
                                      else None)
    if args.steps:
        np.savez(args.steps, seeds=np.array([s for s, _ in steps]),
                 radiance=np.stack([r for _, r in steps]))
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
