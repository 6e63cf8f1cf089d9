#!/usr/bin/env python3
"""Run one cell of the mcpt_torch benchmark once, on the card this machine
holds, and print its result as the last line of standard output:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiler trace of the window's first steps.  Both
compare the window's framebuffer with the plain reference and print each
compared number beside its limit, last, on standard error.  Without a CUDA
card the run exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this directory, heads the module path
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
