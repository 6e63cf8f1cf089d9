#!/usr/bin/env python
"""On-card smoke test of the PyTorch + CUDA port (``mcpt_torch``).

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``mcpt_torch/csrc``, holds each against its
plain PyTorch version on the card, checks the renderer's analytic and golden
oracles, drives the render CLI's main path through the kernel, and times one
render step.  Any failed phase exits nonzero.  Without a CUDA device it exits
nonzero at once: nothing here falls back to the CPU.

Phases, dense megakernel (kernel 1): 1 device, 2 build (both CUDA sources,
one nvcc each, in parallel; the host treelet library with g++), 3 kernel vs
plain version on small views of
each tier, 4 oracles, 5 main path (``mcpt_torch.render_cli`` on configs 0, 2
and 6), 6 kernel vs plain version at the main path's own render steps
(configs 0 and 6, taken from ``config.json``), timed.

Phases, hybrid fused bounce (kernel 2): 7 build report (ptxas's registers,
stack and spill of the kernel), 8 whole ``render_hybrid`` through the
kernel vs through the plain version on boxfield(60) and a small diningroom
view, 9 oracles (hybrid vs megakernel on the same streams; the diningroom
golden), 10 main path (``render_cli`` on configs 7 and 8 at their own size,
16 spp, and config 9 at 4 spp), 11 one bounce at config 8's own pool
(3,686,400 rays, depths 0 and 1), kernel vs plain version, timed.

``python3 chip_smoke.py --crossover`` instead times the two engines through
their kernels on boxfield(n) at 724-6004 triangles (the ``auto`` engine's
crossover); ``--fmad-ab`` the dense kernel built with ``-fmad=false`` and
``-fmad=true``.  The last two lines of standard output are the kernel report
and the result, each one JSON object.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain version: a pixel agrees when |a - b| <= 1e-4·|b| + 1e-5 in
# every channel; the gates are the share of such pixels, the relative
# difference of the image means and the ratio of the segment counts
PIX_RTOL, PIX_ATOL = 1e-4, 1e-5
MIN_SHARE, MAX_MEAN_REL, MAX_SEG_REL = 0.99, 1e-3, 1e-3
# golden gates at 256 spp (rel-RMSE against tests/goldens, 2048 spp)
GOLDENS = [  # (scene, width, height, depth, tolerance)
    ("cornell_box", 128, 128, 16, 0.08),
    ("veach_mis", 192, 128, 8, 0.15),
    ("quad_light_plane", 128, 128, 6, 0.10),
]


def phase(n: int, title: str) -> None:
    print(f"\n== phase {n}: {title}", flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def rel_rmse(a, b) -> float:
    """``tools/compare.compare``'s relative RMSE: rmse(a - b) / rms(b)."""
    import numpy as np

    rmse = float(np.sqrt(((a - b) ** 2).mean()))
    return rmse / max(float(np.sqrt((b ** 2).mean())), 1e-20)


def setup(name, width, height, device, **builder_kw):
    from mcpt_torch import scenes
    from mcpt_torch.kernels import megakernel as mk
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.scene import build_scene

    loaded, camcfg = getattr(scenes, name)(**builder_kw)
    camcfg = dataclasses.replace(camcfg, resolution=(width, height))
    scene, lights = build_scene(loaded, device=device)
    return mk.build_megascene(scene, lights), make_camera(camcfg,
                                                          device=device)


def main_path_step(configid, device):
    """The megakernel call of ``render_cli``'s first step for a config.json
    entry: (mega, camera, width, height, render_mega keyword arguments)."""
    from mcpt_torch.config import load_config
    from mcpt_torch.kernels import megakernel as mk
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.render_cli import build_from_config

    cfg = load_config(os.path.join(ROOT, "config.json"), configid)
    scene, lights, camcfg = build_from_config(cfg, device)
    w = cfg.width or camcfg.resolution[0]
    h = cfg.height or camcfg.resolution[1]
    camcfg = dataclasses.replace(camcfg, resolution=(w, h))
    kw = dict(spp=max(1, cfg.spp_per_step), seed=cfg.seed,
              max_depth=cfg.maxdepth or 16,
              rr=cfg.integrator.russian_roulette,
              rr_start=cfg.integrator.rr_start_depth, nee=cfg.integrator.nee,
              mis=cfg.integrator.mis, clamp=cfg.integrator.clamp)
    return (mk.build_megascene(scene, lights), make_camera(camcfg, device=device),
            w, h, kw)


def parity(label, a, sa, b, sb):
    """Kernel output ``a`` against the plain version's ``b`` (numpy
    (n_pixels, 3) radiance sums, segment counts ``sa``/``sb``): print and
    return the share of pixels within tolerance, the relative difference of
    the means and of the segments, and max |a-b|."""
    import numpy as np

    share = float((np.abs(a - b) <= PIX_RTOL * np.abs(b) + PIX_ATOL)
                  .all(-1).mean())
    mean_rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    seg_rel = abs(float(sa) / float(sb) - 1.0)
    max_abs = float(np.abs(a - b).max())
    print(f"  {label}: pixels within tol {share:.4%}, mean rel diff "
          f"{mean_rel:.2e}, segments {float(sa):.0f} vs {float(sb):.0f} "
          f"(ratio-1 {seg_rel:.2e}), max |a-b| {max_abs:.3e}")
    return share, mean_rel, seg_rel, max_abs


def check_parity(label, a, sa, b, sb, n_pixels) -> float:
    """``parity`` with phase 3's gates: raise past them, return max |a-b|."""
    import numpy as np

    if not np.isfinite(a).all() or a.shape != (n_pixels, 3):
        raise AssertionError(f"{label}: bad output {a.shape}")
    share, mean_rel, seg_rel, max_abs = parity(label, a, sa, b, sb)
    if share < MIN_SHARE or mean_rel > MAX_MEAN_REL or seg_rel > MAX_SEG_REL:
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             "version")
    return max_abs


def run() -> dict:
    import numpy as np
    import torch

    from mcpt_torch import render_cli
    from mcpt_torch.io import image as im
    from mcpt_torch.kernels import _build
    from mcpt_torch.kernels import megakernel as mk

    dev = torch.device("cuda")
    report = {}

    phase(1, "device")
    card = smi()
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])

    phase(2, "build")
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"built {_build.library_path().name} from mcpt_torch/csrc in "
          f"{time.perf_counter() - t0:.2f} s")
    print(_build.library_path().with_suffix(".log").read_text().strip())
    t0 = time.perf_counter()
    _build.load_host()
    print(f"built {_build.host_library_path().name} (g++) from "
          f"mcpt_torch/csrc/host in {time.perf_counter() - t0:.2f} s")

    phase(3, "kernel vs plain version (spp 4, NEE+MIS+RR)")
    max_abs = 0.0
    cases = [("cornell_box", 64, 64, 16, {}), ("veach_mis", 96, 64, 8, {}),
             ("furnace_sphere", 32, 32, 8, {})]
    for name, w, h, depth, kw in cases:
        mega, cam = setup(name, w, h, dev, **kw)
        rows = (mega.tri.shape[0], mega.matt.shape[0], mega.lit.shape[0],
                mega.cbox.shape[0])
        table_kb = 4 * (16 * sum(rows[:3]) + 8 * rows[3]) / 1024
        in_smem = bool(lib.mcpt_tables_in_smem(*rows))
        print(f"{name} {w}x{h}: {mega.n_tris} tris "
              f"({'chunked' if mega.n_tris > mk.UNROLL_MAX_TRIS else 'unrolled'}"
              f" tier), {mega.n_lights} lights, tables {table_kb:.1f} KB "
              f"({'shared' if in_smem else 'global'} memory)")
        if name == "furnace_sphere" and not (in_smem and table_kb > 48):
            raise AssertionError("furnace tables should take shared memory "
                                 "above 48 KB")
        for sched in ("regen", "batch"):
            args = dict(spp=4, seed=11, max_depth=depth, rr=True, nee=True,
                        mis=True, schedule=sched)
            a, sa = mk.render_mega(mega, cam, w, h, **args)
            torch.cuda.synchronize()
            b, sb = mk.render_mega_reference(mega, cam, w, h, **args)
            max_abs = max(max_abs, check_parity(
                f"{name} {sched}", a.cpu().numpy(), sa, b.cpu().numpy(), sb,
                w * h))

    phase(4, "oracles on the kernel")
    mega, cam = setup("furnace_sphere", 16, 16, dev, subdiv=2)
    rad, _ = mk.render_mega(mega, cam, 16, 16, spp=8, seed=0, max_depth=6)
    img = rad.cpu().numpy().reshape(16, 16, 3) / 8.0
    print(f"furnace (640 tris) centre {img[8, 8].tolist()} "
          f"corner {img[0, 0].tolist()}")
    if not (np.allclose(img[8, 8], 0.5, atol=1e-5)
            and np.allclose(img[0, 0], 1.0, atol=1e-5)):
        raise AssertionError("furnace identity fails")
    for name, w, h, depth, tol in GOLDENS:
        golden = im.read_exr_rgb(
            os.path.join(ROOT, "tests", "goldens", f"{name}.exr"))[::-1]
        mega, cam = setup(name, w, h, dev)
        rad, _ = mk.render_mega(mega, cam, w, h, spp=256, seed=5,
                                max_depth=depth, nee=True, mis=True)
        img = rad.cpu().numpy().reshape(h, w, 3) / 256.0
        err = rel_rmse(img.astype(np.float64), golden.astype(np.float64))
        print(f"golden {name} {w}x{h} d{depth} 256 spp: rel-RMSE {err:.4f} "
              f"(gate {tol})")
        if not err < tol:
            raise AssertionError(f"golden gate {name}: {err} >= {tol}")

    phase(5, "main path: mcpt_torch.render_cli")
    runs = [(0, ["--spp", "64"], 4), (6, ["--spp", "64"], 1),
            (2, ["--spp", "16"], 16)]
    mk.LAUNCHES = 0
    steps = 0
    main_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        for cid, extra, n_steps in runs:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = render_cli.main(["--config", os.path.join(
                    ROOT, "config.json"), "--configid", str(cid), "--out",
                    tmp, "--device", "cuda", *extra])
            wall = time.perf_counter() - t0
            text = out.getvalue()
            print(text.strip())
            if rc != 0:
                raise AssertionError(f"render_cli returned {rc}")
            steps += n_steps
            stem = re.search(r"wrote (\S+)\.hdr", text).group(1)
            for ext in ("hdr", "png", "exr"):
                if not os.path.exists(os.path.join(tmp, f"{stem}.{ext}")):
                    raise AssertionError(f"missing {stem}.{ext}")
            img = im.read_exr_rgb(os.path.join(tmp, f"{stem}.exr"))
            last = re.findall(r"\|\s*([\d.]+) spp/s \|\s*([\d.]+) Mrays/s",
                              text)[-1]
            main_path[stem] = dict(spp_per_s=float(last[0]),
                                   mrays=float(last[1]), wall_s=wall,
                                   mean=float(img.mean()))
            print(f"config {cid} ({stem}): {last[1]} Mrays/s, {last[0]} "
                  f"spp/s, wall {wall:.2f} s, image mean {img.mean():.4f}")
            if not np.isfinite(img).all():
                raise AssertionError(f"{stem}: non-finite pixels")
    launches = mk.LAUNCHES
    print(f"kernel launches in the main path: {launches} "
          f"(render steps: {steps})")
    if launches != steps:
        raise AssertionError("the CLI did not run every step through the "
                             "kernel")
    cbox_mean = main_path["cornell_box"]["mean"]
    if not 0.10 <= cbox_mean <= 0.16:
        raise AssertionError(f"cbox image mean {cbox_mean} outside 0.10-0.16")
    report["launches"] = launches
    report["main_path"] = main_path

    phase(6, "main-path steps (configs 0 and 6): kernel vs plain version, "
             "and time per step")
    saved = mk.LAUNCHES
    # (configid, kernel reps, plain reps) per timed pass; the order is plain,
    # kernel, kernel, plain, and the last kernel and plain results (same
    # arguments, so the same seed) go through phase 3's gates
    for cid, k_reps, p_reps in ((0, 10, 2), (6, 3, 1)):
        mega, cam, w, h, kw = main_path_step(cid, dev)

        def timed(fn, reps):
            fn(mega, cam, w, h, **kw)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                rad, segs = fn(mega, cam, w, h, **kw)
            torch.cuda.synchronize()
            return ((time.perf_counter() - t0) / reps * 1e3,
                    rad.cpu().numpy(), float(segs))

        plain_a, _, _ = timed(mk.render_mega_reference, p_reps)
        kern_a, _, _ = timed(mk.render_mega, k_reps)
        kern_b, a, sa = timed(mk.render_mega, k_reps)
        plain_b, b, sb = timed(mk.render_mega_reference, p_reps)
        label = f"config {cid} {w}x{h} {kw['spp']} spp"
        max_abs = max(max_abs, check_parity(label, a, sa, b, sb, w * h))
        ms, plain_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
        print(f"  {label}: kernel {kern_a:.3f} / {kern_b:.3f} ms, plain "
              f"{plain_a:.1f} / {plain_b:.1f} ms per step ({sa:.0f} segments:"
              f" {sa / ms / 1e3:.1f} Mrays/s kernel, "
              f"{sa / plain_ms / 1e3:.2f} Mrays/s plain) | {card}")
        if cid == 0:  # the default config's step is the reported time
            report["ms"], report["plain_ms"] = ms, plain_ms
    mk.LAUNCHES = saved  # comparison launches are not main-path launches
    report["max_abs_err"] = max_abs
    report["card"] = card
    report["hybrid"] = run_hybrid(card)
    return report


def hybrid_setup(name, width, height, device, **builder_kw):
    from mcpt_torch import scenes
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.scene import build_scene

    loaded, camcfg = getattr(scenes, name)(**builder_kw)
    camcfg = dataclasses.replace(camcfg, resolution=(width, height))
    scene, lights = build_scene(loaded, device=device)
    cam = make_camera(camcfg, device=device)
    return scene, lights, cmk.build_cluster_megascene(scene, lights), cam


def config_hybrid_step(configid, device):
    """The hybrid engine's first render step of a config.json entry as
    ``render_cli`` runs it on CUDA: (cms, camera, width, height,
    render_hybrid keyword arguments with the pilot's caps)."""
    from mcpt_torch.config import load_config
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.render import integrator as integ
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.render_cli import build_from_config

    cfg = load_config(os.path.join(ROOT, "config.json"), configid)
    scene, lights, camcfg = build_from_config(cfg, device)
    w = cfg.width or camcfg.resolution[0]
    h = cfg.height or camcfg.resolution[1]
    cam = make_camera(dataclasses.replace(camcfg, resolution=(w, h)),
                      device=device)
    cms = cmk.build_cluster_megascene(scene, lights)
    opts = integ.RenderOptions(
        max_depth=cfg.maxdepth or 16, nee=cfg.integrator.nee,
        mis=cfg.integrator.mis,
        russian_roulette=cfg.integrator.russian_roulette,
        rr_start_depth=cfg.integrator.rr_start_depth)
    kw = dict(spp=max(1, cfg.spp_per_step), seed=cfg.seed,
              max_depth=opts.max_depth, rr=opts.russian_roulette,
              rr_start=opts.rr_start_depth, nee=opts.nee, mis=opts.mis,
              clamp=cfg.integrator.clamp,
              compact=integ.measure_schedule(cms, cam, opts))
    return cms, cam, w, h, kw


def run_hybrid(card) -> dict:
    """Phases 7-11: the hybrid engine and its fused-bounce kernel."""
    import numpy as np
    import torch

    from mcpt_torch import render_cli
    from mcpt_torch.io import image as im
    from mcpt_torch.kernels import _build
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.kernels import megakernel as mk

    dev = torch.device("cuda")
    out = {}

    phase(7, "build report (hybrid): fused-bounce kernel")
    # both libraries were built in phase 2 (each CUDA source by its own nvcc)
    log = _build.library_path().with_suffix(".log").read_text()
    fused = log[log.index("fused_bounce_kernel"):].splitlines()[:4]
    print("fused_bounce_kernel ptxas: " + " | ".join(x.strip() for x in fused))

    phase(8, "render_hybrid through the kernel vs through the plain version "
             "(spp 2, depth 4, NEE+MIS+RR)")
    max_abs = 0.0
    for name, w, h, kw in (("boxfield", 64, 48, {"n_boxes": 60}),
                           ("diningroom", 64, 36, {})):
        _, _, cms, cam = hybrid_setup(name, w, h, dev, **kw)
        print(f"{name} {w}x{h}: {cms.tri16.shape[0]} tri rows in "
              f"{cms.n_clusters} clusters, {cms.wnodes.shape[0]} wide nodes, "
              f"{cms.n_lights} lights")
        for key_mode, compact in (("cell", None), ("dir6", None),
                                  ("cell", (0.4, 0.25, 0.2)),
                                  ("dir6", (0.4, 0.25, 0.2))):
            args = dict(spp=2, seed=13, max_depth=4, rr=True, rr_start=1,
                        nee=True, mis=True, key_mode=key_mode,
                        compact=compact)
            a, sa = cmk.render_hybrid(cms, cam, w, h, **args)
            torch.cuda.synchronize()
            b, sb = cmk.render_hybrid_reference(cms, cam, w, h, **args)
            max_abs = max(max_abs, check_parity(
                f"{name} {key_mode} compact={compact}", a.cpu().numpy(),
                float(sa), b.cpu().numpy(), float(sb), w * h))

    phase(9, "oracles on the hybrid")
    scene, lights, cms, cam = hybrid_setup("boxfield", 64, 48, dev,
                                           n_boxes=60)
    args = dict(spp=4, seed=21, max_depth=6, rr=True, rr_start=2, nee=True,
                mis=True)
    a, sa = cmk.render_hybrid(cms, cam, 64, 48, compact=None, **args)
    b, sb = mk.render_mega(mk.build_megascene(scene, lights), cam, 64, 48,
                           schedule="batch", **args)
    check_parity("boxfield(60) hybrid vs megakernel (batch), same streams",
                 a.cpu().numpy(), float(sa), b.cpu().numpy(), float(sb),
                 64 * 48)
    golden = im.read_exr_rgb(os.path.join(ROOT, "tests", "goldens",
                                          "diningroom.exr"))[::-1]
    _, _, cms, cam = hybrid_setup("diningroom", 160, 90, dev)
    rad, _ = cmk.render_hybrid(cms, cam, 160, 90, spp=16, seed=5,
                               max_depth=8, nee=True, mis=True)
    img = rad.cpu().numpy().reshape(90, 160, 3) / 16.0
    err = rel_rmse(img.astype(np.float64), golden.astype(np.float64))
    print(f"golden diningroom 160x90 d8 16 spp: rel-RMSE {err:.4f} "
          "(gate 0.35)")
    if not err < 0.35:
        raise AssertionError(f"golden gate diningroom: {err} >= 0.35")

    phase(10, "main path: mcpt_torch.render_cli on configs 7, 8 and 9")
    runs = [(7, ["--spp", "16"], 4), (8, ["--spp", "16"], 4),
            (9, ["--spp", "4"], 1)]
    cmk.LAUNCHES = mk.LAUNCHES = 0
    expected = 0
    main_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        for cid, extra, n_steps in runs:
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = render_cli.main(["--config", os.path.join(
                    ROOT, "config.json"), "--configid", str(cid), "--out",
                    tmp, "--device", "cuda", *extra])
            wall = time.perf_counter() - t0
            text = buf.getvalue()
            print(text.strip())
            if rc != 0 or "engine: hybrid" not in text:
                raise AssertionError(f"config {cid}: render_cli returned "
                                     f"{rc} or took another engine")
            # 8 bounces per render step, and 8 for the pilot's own render
            expected += 8 * (n_steps + 1)
            stem = re.search(r"wrote (\S+)\.hdr", text).group(1)
            img = im.read_exr_rgb(os.path.join(tmp, f"{stem}.exr"))
            last = re.findall(r"\|\s*([\d.]+) spp/s \|\s*([\d.]+) Mrays/s",
                              text)[-1]
            build_s = float(re.search(r"scene build: ([\d.]+) s",
                                      text).group(1))
            caps = re.search(r"pilot caps (\([^)]*\)|None)", text).group(1)
            key = re.search(r"key mode (\w+)", text).group(1)
            main_path[f"config {cid}"] = dict(
                spp_per_s=float(last[0]), mrays=float(last[1]), wall_s=wall,
                mean=float(img.mean()), build_s=build_s, caps=caps,
                key_mode=key)
            print(f"config {cid} ({stem}): scene build {build_s:.2f} s, "
                  f"pilot caps {caps}, key mode {key}, {last[1]} Mrays/s, "
                  f"{last[0]} spp/s, wall {wall:.2f} s, image mean "
                  f"{img.mean():.4f} | {card}")
            if not np.isfinite(img).all() or not img.mean() > 0.0:
                raise AssertionError(f"{stem}: non-finite or black image")
            if "nan" in text.lower() or "inf " in text.lower():
                raise AssertionError(f"{stem}: non-finite segment count")
    launches = cmk.LAUNCHES
    print(f"fused-bounce launches in the main path: {launches} (8 bounces × "
          f"(render steps + one pilot render) = {expected}); dense-kernel "
          f"launches: {mk.LAUNCHES}")
    if launches != expected or mk.LAUNCHES != 0:
        raise AssertionError("the CLI did not run every bounce through the "
                             "fused-bounce kernel")
    out["launches"] = launches
    out["main_path"] = main_path

    phase(11, "one bounce at config 8's own pool: kernel vs plain version, "
              "timed (CUDA events)")
    saved = cmk.LAUNCHES
    cms, cam, w, h, kw = config_hybrid_step(8, dev)
    n_rays = w * h * kw["spp"]
    n_pool = -(-n_rays // cmk.BLKT) * cmk.BLKT
    state, rid = cmk.camera_pool(cms, cam, w, h, kw["spp"], kw["seed"],
                                 n_pool)
    key_mode = cmk.resolve_key_mode("auto", kw["compact"])
    bkw = {k: kw[k] for k in ("max_depth", "rr", "rr_start", "nee", "mis",
                              "clamp")}
    times = {}
    for depth in (0, 1):
        def timed(fn):
            x = state.clone()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            segs = fn(cms, x, rid, kw["seed"], depth, **bkw)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end), x, segs

        plain_a, b, sb = timed(cmk.fused_bounce_reference)
        kern_a, _, _ = timed(cmk.fused_bounce)
        kern_b, a, sa = timed(cmk.fused_bounce)
        plain_b, _, _ = timed(cmk.fused_bounce_reference)
        live = a[cmk.ALIVE] > 0
        same = (torch.equal(a[9:13], b[9:13]) and torch.equal(sa, sb)
                and torch.equal(a[:, live], b[:, live]))
        diff = float((a[9:12] - b[9:12]).abs().max())
        max_abs = max(max_abs, diff)
        ms, plain_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
        seg = float(sa.double().sum())
        print(f"  depth {depth}: {n_rays} rays in a {n_pool}-lane pool, "
              f"{int(live.sum())} live after; bit-equal {same} (max |a-b| "
              f"radiance {diff:.3e}); kernel {kern_a:.3f} / {kern_b:.3f} ms, "
              f"plain {plain_a:.1f} / {plain_b:.1f} ms; {seg:.0f} segments:"
              f" {seg / ms / 1e3:.1f} Mrays/s kernel | {card}")
        if not same:
            raise AssertionError(f"depth {depth}: kernel disagrees with the "
                                 "plain version at the main path's pool")
        times[depth] = (ms, plain_ms)
        # the next depth starts from the kernel's output, re-sorted as the
        # pipeline sorts it
        key = cmk._hybrid_sort_key(*a[:6], a[cmk.ALIVE], cms.bb_lo,
                                   cms.bb_inv_ext, key_mode)
        order = torch.sort(key, stable=True).indices
        state, rid = a.index_select(1, order), rid[order]
    cmk.LAUNCHES = saved  # comparison launches are not main-path launches
    out["ms"], out["plain_ms"] = times[0]
    out["max_abs_err"] = max_abs
    return out


def crossover(spp: int = 16, step: int = 4) -> None:
    """``--crossover``: the dense megakernel against the hybrid, each through
    its kernel, on boxfield(n) at 724, 1204, 2404 and 6004 triangles
    (``mcpt``'s sweep, tools/render.py:145-149) and at 1564, 1804 and 2044
    between the two sizes where the engines swap: 1280x720, depth 8,
    NEE+MIS+RR, ``spp`` samples in steps of ``step`` as the CLI renders
    config 7 (the hybrid with its pilot's caps).  Prints Mrays/s and spp/s
    of each engine."""
    import torch

    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.kernels import megakernel as mk
    from mcpt_torch.render import integrator as integ

    dev = torch.device("cuda")
    card = smi()
    print(f"nvidia-smi: {card}")
    w, h = 1280, 720
    opts = integ.RenderOptions(max_depth=8, nee=True, mis=True,
                               russian_roulette=True)
    kw = dict(max_depth=8, rr=True, rr_start=3, nee=True, mis=True)
    for n_boxes in (60, 100, 130, 150, 170, 200, 500):
        scene, lights, cms, cam = hybrid_setup("boxfield", w, h, dev,
                                               n_boxes=n_boxes)
        mega = mk.build_megascene(scene, lights)
        compact = integ.measure_schedule(cms, cam, opts)
        engines = {
            "mega": lambda s, seed: mk.render_mega(mega, cam, w, h, spp=s,
                                                   seed=seed, **kw),
            "hybrid": lambda s, seed: cmk.render_hybrid(
                cms, cam, w, h, spp=s, seed=seed, compact=compact, **kw),
        }
        res = {}
        for name in ("mega", "hybrid", "hybrid", "mega"):
            engines[name](step, 1)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            segs = 0.0
            for i in range(spp // step):
                _, sg = engines[name](step, 1 + i * 7919)
                segs += float(sg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            res.setdefault(name, []).append((segs / dt / 1e6, spp / dt))
            print(f"  boxfield({n_boxes}) {scene.n_tris} tris {name}: "
                  f"{segs / dt / 1e6:.2f} Mrays/s, {spp / dt:.2f} spp/s, "
                  f"{segs:.0f} segments in {dt * 1e3:.1f} ms | {card}")
        m = sum(r[0] for r in res["mega"]) / 2
        hy = sum(r[0] for r in res["hybrid"]) / 2
        print(f"boxfield({n_boxes}) {scene.n_tris} tris: mega {m:.2f}, "
              f"hybrid {hy:.2f} Mrays/s (pilot caps {compact}) -> "
              f"{'mega' if m >= hy else 'hybrid'} | {card}")


def fmad_ab(reps: int = 10) -> None:
    """``--fmad-ab``: the kernel built with ``_build.NVCC_FLAGS``
    (``-fmad=false``) against the same sources built with ``-fmad=true``.
    Prints each build's ptxas report, its parity with the plain version on
    phase 3's cbox and veach_mis views (no gate: contraction is expected to
    move coplanar ties), and the time of configs 0 and 6's main-path steps
    by CUDA events, in the order false, true, true, false within this one
    process."""
    import inspect

    import torch

    from mcpt_torch.kernels import _build
    from mcpt_torch.kernels import megakernel as mk

    dev = torch.device("cuda")
    print(f"nvidia-smi: {smi()}")
    variants = {"-fmad=false": _build.NVCC_FLAGS,
                "-fmad=true": tuple("-fmad=true" if f == "-fmad=false" else f
                                    for f in _build.NVCC_FLAGS)}
    kernels = {}
    for name, flags in variants.items():
        lib = _build.load(flags)
        log = _build.library_path(flags).with_suffix(".log").read_text()
        print(f"{name}: " + " | ".join(
            line.strip() for line in log.splitlines() if "registers" in line
            or "stack frame" in line))

        def render(*args, lib=lib, **kw):
            bound = inspect.signature(mk.render_mega).bind(*args, **kw)
            bound.apply_defaults()
            return mk._render_mega_cuda(*bound.args, lib=lib)
        kernels[name] = render

    print("parity with the plain version (spp 4, NEE+MIS+RR):")
    for scene, w, h, depth in (("cornell_box", 64, 64, 16),
                               ("veach_mis", 96, 64, 8)):
        mega, cam = setup(scene, w, h, dev)
        for sched in ("regen", "batch"):
            kw = dict(spp=4, seed=11, max_depth=depth, rr=True, nee=True,
                      mis=True, schedule=sched)
            b, sb = mk.render_mega_reference(mega, cam, w, h, **kw)
            for name, render in kernels.items():
                a, sa = render(mega, cam, w, h, **kw)
                parity(f"{scene} {w}x{h} {sched} {name}", a.cpu().numpy(),
                       sa, b.cpu().numpy(), sb)

    print(f"time per main-path step (CUDA events, mean of {reps}):")
    for cid in (0, 6):
        mega, cam, w, h, kw = main_path_step(cid, dev)
        times = {name: [] for name in kernels}
        for name in ("-fmad=false", "-fmad=true", "-fmad=true",
                     "-fmad=false"):
            kernels[name](mega, cam, w, h, **kw)  # warm-up
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(reps):
                _, segs = kernels[name](mega, cam, w, h, **kw)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
            print(f"  config {cid} {w}x{h} {kw['spp']} spp {name}: "
                  f"{times[name][-1]:.3f} ms ({float(segs):.0f} segments)")
        gain = 1 - sum(times["-fmad=true"]) / sum(times["-fmad=false"])
        print(f"  config {cid}: -fmad=true takes {gain:.1%} less time")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fmad-ab", action="store_true",
                    help="only measure -fmad=false against -fmad=true")
    ap.add_argument("--crossover", action="store_true",
                    help="only time the megakernel against the hybrid on "
                         "boxfield(n), 724-6004 tris")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        if args.fmad_ab:
            fmad_ab()
            return 0
        if args.crossover:
            crossover()
            return 0
        report = run()
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(report["card"])
    print(json.dumps({"kernels": [{
        "name": "render_mega",
        "route": "cuda",
        "source": "mcpt_torch/csrc/megakernel.cu",
        "replaces": "mcpt/pallas/megakernel.py:1168",
        "launches": report["launches"],
        "max_abs_err": report["max_abs_err"],
        "ms": report["ms"],
        "plain_ms": report["plain_ms"],
    }, {
        "name": "fused_bounce",
        "route": "cuda",
        "source": "mcpt_torch/csrc/fused_bounce.cu",
        "replaces": "mcpt/pallas/cluster_megakernel.py:586",
        "launches": report["hybrid"]["launches"],
        "max_abs_err": report["hybrid"]["max_abs_err"],
        "ms": report["hybrid"]["ms"],
        "plain_ms": report["hybrid"]["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
