#!/usr/bin/env python
"""RMSE / image-difference harness against ground-truth renders (the port's
``tools/compare.py``).

RMSE, relative RMSE and mean relative error between two images (EXR/HDR,
read by ``mcpt_torch.io.image``), with an optional vertical flip and
exposure alignment.  Pure numpy: no device.

Usage:
    python -m mcpt_torch.compare render.exr tests/goldens/cornell_box.exr \
        [--flip-a] [--align-exposure] [--tolerance 0.01]

Exits 1 when ``--tolerance`` is given and the relative RMSE exceeds it, so
it serves as a CI gate.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_image(path: str) -> np.ndarray:
    from mcpt_torch.io import image as im

    if path.endswith(".exr"):
        return im.read_exr_rgb(path)
    if path.endswith(".hdr"):
        return im.read_hdr(path)
    raise SystemExit(f"unsupported image format: {path}")


def compare(a: np.ndarray, b: np.ndarray, align_exposure: bool = False):
    """Image ``a`` against the reference ``b`` → dict of ``rmse``,
    ``rel_rmse`` (RMSE over the RMS of ``b``), ``mean_rel_err`` (|a-b| over
    max(|b|, 1e-3), averaged) and ``exposure_scale`` (the least-squares
    scale of ``a`` onto ``b`` with ``align_exposure``, else 1)."""
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch: {a.shape} vs {b.shape}")
    scale = 1.0
    if align_exposure:
        num = float((a * b).sum())
        den = float((a * a).sum())
        scale = num / max(den, 1e-20)
        a = a * scale
    diff = a - b
    rmse = float(np.sqrt((diff**2).mean()))
    ref_rms = float(np.sqrt((b**2).mean()))
    rel_rmse = rmse / max(ref_rms, 1e-20)
    mre = float((np.abs(diff) / np.maximum(np.abs(b), 1e-3)).mean())
    return dict(rmse=rmse, rel_rmse=rel_rmse, mean_rel_err=mre,
                exposure_scale=scale)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("image_a")
    ap.add_argument("image_b", help="ground truth / reference image")
    ap.add_argument("--flip-a", action="store_true",
                    help="vertically flip image A before comparing")
    ap.add_argument("--align-exposure", action="store_true",
                    help="least-squares scale A onto B first")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="fail (exit 1) if relative RMSE exceeds this")
    args = ap.parse_args(argv)

    a = load_image(args.image_a)
    b = load_image(args.image_b)
    if args.flip_a:
        a = a[::-1]
    stats = compare(a, b, align_exposure=args.align_exposure)
    for k, v in stats.items():
        print(f"{k}: {v:.6f}")
    if args.tolerance is not None and stats["rel_rmse"] > args.tolerance:
        print(f"FAIL: rel_rmse {stats['rel_rmse']:.4f} > {args.tolerance}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
