"""The plain reference of a window: every sample of every step, for a set
of pixels, as whole paths (one lane per (step, sample, pixel)).

Sample s of a step with seed ``seed`` at pixel p draws the RNG stream
``s·W·H + p`` under that seed; its path is the scene format's estimator
(``path.bounce``) through the reference's own intersector (``hits.Hits``).
The radiance and segment sums per pixel are kept in float64.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference import path, tables
from benchmark.reference.hits import Hits


def prepare(scene: dict, cfg: dict, device, dt=torch.float32):
    """Everything a window's reference needs that depends on the scene and
    the configuration alone: (tables, intersector)."""
    tab = tables.build(scene)
    w, h = cfg["width"], cfg["height"]
    cam = tables.camera(scene["camera"], w, h)
    sf = list(cam.sf)
    integ = cfg["integrator"]
    sf[14], sf[15] = tab.eps, float(np.float32(cfg["t_min"]))
    sf[16] = tab.total_light_area
    sf[18] = float(np.float32(integ["clamp"]))
    lit = torch.from_numpy(tab.lit).to(device, dt)
    ns = SimpleNamespace(
        dt=dt, sf=sf, matt=torch.from_numpy(tab.matt).to(device, dt),
        lit=lit, cdf=lit[:tab.n_lights, 15].contiguous(),
        n_lights=tab.n_lights, use_nee=bool(integ["nee"]) and tab.n_lights > 0,
        use_mis=bool(integ["mis"]), width=w, height=h,
        max_depth=int(cfg["maxdepth"]), rr=bool(integ["russian_roulette"]),
        rr_start=int(integ["rr_start_depth"]))
    return ns, Hits(tab.rows, tab.verts, device, dt)


def render_pixels(ref, hits: Hits, pixels, seeds, spp: int,
                  lanes_per_block: int = 1 << 20):
    """(K,) pixel ids, the window's step seeds, spp a step → ((K, 3)
    radiance sums, (K,) segment sums), float64 numpy."""
    dev = hits.rows.device
    dt, total = ref.dt, ref.width * ref.height
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
    sd = torch.as_tensor(np.asarray(seeds, np.int64) & path.M32, device=dev)
    k, n_lanes = pix.numel(), len(seeds) * spp * pix.numel()
    rad = torch.zeros((k, 3), dtype=torch.float64, device=dev)
    segs = torch.zeros(k, dtype=torch.float64, device=dev)
    for s0 in range(0, n_lanes, lanes_per_block):
        lane = torch.arange(s0, min(n_lanes, s0 + lanes_per_block),
                            dtype=torch.int64, device=dev)
        slot = lane % k
        sample = (lane // k) % spp
        seed = sd[lane // (k * spp)]
        pixel = pix[slot]
        idx = (sample * total + pixel) & path.M32
        o, d = path.camera_ray(ref.sf, seed, pixel, idx, ref.width,
                               ref.height, dt)
        n = lane.numel()

        def full(v):
            return torch.full((n,), v, dtype=dt, device=dev)

        st = dict(ox=o[0] + full(0.0), oy=o[1] + full(0.0),
                  oz=o[2] + full(0.0), dx=d[0], dy=d[1], dz=d[2],
                  tr=full(1.0), tg=full(1.0), tb=full(1.0), rr=full(0.0),
                  rg=full(0.0), rb=full(0.0), alive=full(1.0),
                  inside=full(0.0), prev_sc=full(0.0), prev_pdf=full(0.0),
                  segs=torch.zeros(n, dtype=torch.float32, device=dev))
        for it in range(ref.max_depth):
            live = torch.nonzero(st["alive"] > 0.0).squeeze(1)
            if live.numel() == 0:
                break
            sub = {key: v[live] for key, v in st.items()}
            sub = path.bounce(
                ref, sub, seed[live], 8 * it + 3, idx[live],
                float(it + 1 < ref.max_depth),
                float(ref.rr and it >= ref.rr_start), hits.closest,
                hits.occluded)
            for key, v in sub.items():
                st[key][live] = v
        lane_rad = torch.stack([st["rr"], st["rg"], st["rb"]], dim=1)
        rad.index_add_(0, slot, lane_rad.to(torch.float64))
        segs.index_add_(0, slot, st["segs"].to(torch.float64))
    return rad.cpu().numpy(), segs.cpu().numpy()
