"""The comparison that decides ``correct``: what the window produced
against the plain reference's recomputation of the same samples, with the
same random numbers.  A cell's ``limits/<workload>.json`` names the pixels
it samples, whether it checks a whole step, and a limit for each number.

A sampled pixel's gap is the largest |program − reference| over its r, g,
b sums over every sample of the window, relative to the reference's value
plus a floor of a hundredth of the sample's mean (a dark channel is judged
on the image's scale).  A sound program follows each path the reference
follows, so its gaps are the rounding of float32 sums; now and then one
path of thousands takes another turn (an ulp at a shared edge or a cluster
box's face), which moves one pixel's gap to about one path's share of its
sum.  So the numbers are robust to a few such pixels:

- ``pixel_gap_p90``: the 90th percentile of the sampled pixels' gaps.
  Catches an error on more than a tenth of the image, however small.
- ``pixel_gap_mean``: their mean.  Catches a large error on a few pixels.
- ``count_gap``: the largest difference between a sampled pixel's sample
  count and the samples the window rendered.  Exact.
- ``step_segs_gap`` (cells with ``full_step``): the segments the program
  counted in one step of the window, drawn from the seed, against the
  reference's count over every pixel and sample of that step, relative.

The largest gap is printed beside them, and not compared.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("pixel_gap_p90", "pixel_gap_mean", "count_gap", "step_segs_gap")


def compare(prog_rad, prog_count, ref_rad, n_samples: int,
            step_segs=None) -> dict:
    """→ {number: value}; ``step_segs`` = (program's, reference's) segments
    of the checked step, or None.  A NaN reads as infinity."""
    gaps = pixel_gaps(prog_rad, ref_rad)
    out = dict(
        pixel_gap_p90=float(np.percentile(gaps, 90)),
        pixel_gap_mean=float(gaps.mean()),
        pixel_gap_max=float(gaps.max()),
        count_gap=float(np.abs(np.asarray(prog_count, np.float64)
                               - n_samples).max()))
    if step_segs is not None:
        prog, ref = step_segs
        out["step_segs_gap"] = abs(float(prog) - float(ref)) / float(ref)
    return {k: (math.inf if math.isnan(v) else v) for k, v in out.items()}


def pixel_gaps(prog_rad, ref_rad) -> np.ndarray:
    """(K,) each sampled pixel's gap (NaN reads as infinity)."""
    prog_rad = np.asarray(prog_rad, np.float64)
    ref_rad = np.asarray(ref_rad, np.float64)
    floor = max(0.01 * float(np.abs(ref_rad).mean()), 1e-30)
    gaps = (np.abs(prog_rad - ref_rad) / (np.abs(ref_rad) + floor)).max(1)
    return np.where(np.isnan(gaps), np.inf, gaps)


def compared(limits: dict) -> list:
    """The numbers a cell compares, in ``NUMBERS`` order."""
    return [k for k in NUMBERS if k in limits]


def verdict(values: dict, limits: dict) -> bool:
    return all(values.get(k, math.inf) <= limits[k] for k in compared(limits))


def lines(values: dict, limits: dict) -> list:
    return [f"check {k} {values.get(k, math.inf)!r} limit {limits[k]!r}"
            for k in compared(limits)]
