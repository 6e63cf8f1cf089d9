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

Phases, cluster megakernel (kernel 3) and wavefront traversal (kernel 4):
12 build report (ptxas's registers, stack and spill of every kernel, kernel
1's beside its build before the shared render body), 13 whole
``render_cluster_mega`` through the kernel vs the plain version on
boxfield(60) and a small diningroom view in both schedules, then at config
7's own step, timed, 14 ``intersect_clusters`` / ``occluded_clusters`` at
config 8's own 3,686,400-ray pools (primary and depth-1 rays, a random
active mask, random limits), kernel vs plain version, timed, 15 oracles
(cluster-mega vs the megakernel and the hybrid on the same streams, the
wavefront through kernel 4 vs through the plain traversal, the furnace
identity through the wavefront, the diningroom golden through both new
engines), 16 main path (``render_cli`` on configs 7 and 8 at their own size,
16 spp, through ``cluster-mega`` and the wavefront, each from a one-entry
copy of its config entry), with each engine's kernel launch count.

The kernel report gives, for each kernel, its launches on the main path,
its time and its plain version's at a main-path shape, and its bound: the
larger of the bytes it must move over 3.35 TB/s and the float operations of
the boxes and rows its walks test (counted by the plain versions) over 67
TFLOP/s.

``python3 chip_smoke.py --crossover`` instead times the two engines through
their kernels on boxfield(n) at 724-6004 triangles (the ``auto`` engine's
crossover); ``--fmad-ab`` the dense kernel built with ``-fmad=false`` and
``-fmad=true``; ``--engine-ab`` the three large-scene engines on configs 7
and 8 at 64 spp with a ``torch.profiler`` window each.  The last two lines
of standard output are the kernel report and the result, each one JSON
object.
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
# the least time the card could take: the larger of the bytes a call must
# move over the memory rate and its float32 operations over the peak rate
# (NVIDIA H100 SXM data sheet, 700 W).  A child-box slab test is 23 float
# operations (6 sub, 6 mul, 6 per-axis min/max, 4 min/max of t-near/t-far,
# 1 max with 0), a Wald row test 40 (three affine rows: 33 mul/add, the
# quotient 2, u and v 4, u+v 1)
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
BOX_FLOPS, ROW_FLOPS = 23, 40
# golden gates at 256 spp (rel-RMSE against tests/goldens, 2048 spp)
GOLDENS = [  # (scene, width, height, depth, tolerance)
    ("cornell_box", 128, 128, 16, 0.08),
    ("veach_mis", 192, 128, 8, 0.15),
    ("quad_light_plane", 128, 128, 6, 0.10),
]


def phase(n: int, title: str) -> None:
    print(f"\n== phase {n}: {title}", flush=True)


def bound(nbytes: float, boxes: float, rows: float):
    """(bound_ms, bound_by) of a call that moves ``nbytes`` and slab-tests
    ``boxes`` child boxes and Wald-tests ``rows`` triangle rows."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = (boxes * BOX_FLOPS + rows * ROW_FLOPS) / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def config_scene(configid, device):
    """A config.json entry as render_cli builds it: (cfg, scene, lights,
    camera, width, height)."""
    from mcpt_torch.config import load_config
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.render_cli import build_from_config

    cfg = load_config(os.path.join(ROOT, "config.json"), configid)
    scene, lights, camcfg = build_from_config(cfg, device)
    w = cfg.width or camcfg.resolution[0]
    h = cfg.height or camcfg.resolution[1]
    cam = make_camera(dataclasses.replace(camcfg, resolution=(w, h)),
                      device=device)
    return cfg, scene, lights, cam, w, h


def step_kwargs(cfg) -> dict:
    """The engine keyword arguments of render_cli's first render step."""
    return dict(spp=max(1, cfg.spp_per_step), seed=cfg.seed,
                max_depth=cfg.maxdepth or 16,
                rr=cfg.integrator.russian_roulette,
                rr_start=cfg.integrator.rr_start_depth,
                nee=cfg.integrator.nee, mis=cfg.integrator.mis,
                clamp=cfg.integrator.clamp)


def main_path_step(configid, device):
    """The megakernel call of ``render_cli``'s first step for a config.json
    entry: (mega, camera, width, height, render_mega keyword arguments)."""
    from mcpt_torch.kernels import megakernel as mk

    cfg, scene, lights, cam, w, h = config_scene(configid, device)
    return mk.build_megascene(scene, lights), cam, w, h, step_kwargs(cfg)


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
        mk.WORK.update(boxes=0, rows=0)
        plain_b, b, sb = timed(mk.render_mega_reference, p_reps)
        work = {k: v / (p_reps + 1) for k, v in mk.WORK.items()}
        label = f"config {cid} {w}x{h} {kw['spp']} spp"
        max_abs = max(max_abs, check_parity(label, a, sa, b, sb, w * h))
        ms, plain_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
        print(f"  {label}: kernel {kern_a:.3f} / {kern_b:.3f} ms, plain "
              f"{plain_a:.1f} / {plain_b:.1f} ms per step ({sa:.0f} segments:"
              f" {sa / ms / 1e3:.1f} Mrays/s kernel, "
              f"{sa / plain_ms / 1e3:.2f} Mrays/s plain) | {card}")
        # regen at spp > 1 and batch at spp 1: one lane per pixel
        b_ms, b_by = bound(nbytes(mega.tri, mega.matt, mega.lit, mega.cbox)
                           + 19 * 4 + 16 * w * h, work["boxes"],
                           work["rows"])
        print(f"  {label}: {work['rows']:.0f} rows and {work['boxes']:.0f} "
              f"boxes tested a step -> bound {b_ms:.4f} ms ({b_by}); "
              f"kernel 1's cbox step as first recorded: 6.654 ms (PERF.md)")
        if cid == 0:  # the default config's step is the reported time
            report["ms"], report["plain_ms"] = ms, plain_ms
            report["bound_ms"], report["bound_by"] = b_ms, b_by
    mk.LAUNCHES = saved  # comparison launches are not main-path launches
    report["max_abs_err"] = max_abs
    report["card"] = card
    report["hybrid"] = run_hybrid(card)
    report.update(run_slice3(card))
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
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.render import integrator as integ

    cfg, scene, lights, cam, w, h = config_scene(configid, device)
    cms = cmk.build_cluster_megascene(scene, lights)
    kw = step_kwargs(cfg)
    opts = integ.RenderOptions(
        max_depth=kw["max_depth"], nee=kw["nee"], mis=kw["mis"],
        russian_roulette=kw["rr"], rr_start_depth=kw["rr_start"])
    kw["compact"] = integ.measure_hybrid_schedule(cms, cam, opts)
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

        # warm-up, then kernel, plain, kernel: the plain bounce takes
        # seconds, so it runs once per depth
        timed(cmk.fused_bounce)
        kern_a, _, _ = timed(cmk.fused_bounce)
        cmk.WALK_WORK.update(boxes=0, rows=0)
        plain, b, sb = timed(cmk.fused_bounce_reference)
        work = dict(cmk.WALK_WORK)
        kern_b, a, sa = timed(cmk.fused_bounce)
        live = a[cmk.ALIVE] > 0
        same = (torch.equal(a[9:13], b[9:13]) and torch.equal(sa, sb)
                and torch.equal(a[:, live], b[:, live]))
        diff = float((a[9:12] - b[9:12]).abs().max())
        max_abs = max(max_abs, diff)
        ms, plain_ms = (kern_a + kern_b) / 2, plain
        seg = float(sa.double().sum())
        print(f"  depth {depth}: {n_rays} rays in a {n_pool}-lane pool, "
              f"{int(live.sum())} live after; bit-equal {same} (max |a-b| "
              f"radiance {diff:.3e}); kernel {kern_a:.3f} / {kern_b:.3f} ms, "
              f"plain {plain:.1f} ms; {seg:.0f} segments:"
              f" {seg / ms / 1e3:.1f} Mrays/s kernel | {card}")
        if not same:
            raise AssertionError(f"depth {depth}: kernel disagrees with the "
                                 "plain version at the main path's pool")
        b_ms, b_by = bound(nbytes(cms.wnodes, cms.tri16, cms.matt, cms.lit,
                                  rid) + 2 * nbytes(state) + 4 * n_pool,
                           work["boxes"], work["rows"])
        print(f"  depth {depth}: {work['boxes']} boxes and {work['rows']} "
              f"rows tested -> bound {b_ms:.4f} ms ({b_by})")
        times[depth] = (ms, plain_ms, b_ms, b_by)
        # the next depth starts from the kernel's output, re-sorted as the
        # pipeline sorts it
        key = cmk._hybrid_sort_key(*a[:6], a[cmk.ALIVE], cms.bb_lo,
                                   cms.bb_inv_ext, key_mode)
        order = torch.sort(key, stable=True).indices
        state, rid = a.index_select(1, order), rid[order]
    cmk.LAUNCHES = saved  # comparison launches are not main-path launches
    out["ms"], out["plain_ms"], out["bound_ms"], out["bound_by"] = times[0]
    out["max_abs_err"] = max_abs
    return out


def ptxas_report(log: str) -> dict:
    """ptxas's registers, stack frame and spills for each kernel entry in a
    build log → {mangled name: (registers, stack B, spill stores B, spill
    loads B)}."""
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        stack = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                          r" (\d+) bytes spill loads", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        out[name] = (int(regs.group(1)), *(int(x) for x in stack.groups()))
    return out


def cuda_ms(fn, reps=1):
    """Mean time of ``fn()`` by CUDA events over ``reps`` calls, and the
    last result."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def run_slice3(card) -> dict:
    """Phases 12-16: the cluster megakernel (kernel 3) and the wavefront
    engine's cluster traversal (kernel 4)."""
    import numpy as np
    import torch

    from mcpt_torch import render_cli, rng
    from mcpt_torch.config import write_config_variant
    from mcpt_torch.io import image as im
    from mcpt_torch.kernels import _build
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.kernels import megakernel as mk
    from mcpt_torch.kernels import traverse_kernel as tk
    from mcpt_torch.render import camera as camera_mod
    from mcpt_torch.render import integrator as integ
    from mcpt_torch.render import shade as shade_mod
    from mcpt_torch.render import traverse
    from mcpt_torch.types import RayPool

    dev = torch.device("cuda")
    out = {}

    t_phase = time.perf_counter()
    phase(12, "build report: ptxas per kernel")
    rep = ptxas_report(_build.library_path().with_suffix(".log").read_text())
    for key, label in (("render_mega_kernel", "kernel 1 render_mega_kernel"),
                       ("fused_bounce_kernel", "kernel 2 fused_bounce_kernel"),
                       ("render_cluster_kernel",
                        "kernel 3 render_cluster_kernel"),
                       ("traverse_kernelILb0", "kernel 4 traverse_kernel "
                        "(closest hit)"),
                       ("traverse_kernelILb1", "kernel 4 traverse_kernel "
                        "(any hit)")):
        name = next(n for n in rep if key in n)
        regs, stack, st, ld = rep[name]
        print(f"{label}: {regs} registers, {stack} B stack, {st} B spill "
              f"stores, {ld} B spill loads")
    print("kernel 1 before the shared render body (PERF.md): 96 "
          "registers, 48 B stack, 16 B spill stores; its bits: phase 3")
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    phase(13, "kernel 3 vs its plain version (spp 2, depth 4, NEE+MIS+RR), "
              "then at config 7's own step, timed")
    max_abs3 = 0.0
    for name, w, h, kw in (("boxfield", 64, 48, {"n_boxes": 60}),
                           ("diningroom", 64, 36, {})):
        _, _, cms, cam = hybrid_setup(name, w, h, dev, **kw)
        for sched in ("regen", "batch"):
            args = dict(spp=2, seed=17, max_depth=4, rr=True, rr_start=1,
                        nee=True, mis=True, schedule=sched)
            a, sa = cmk.render_cluster_mega(cms, cam, w, h, **args)
            torch.cuda.synchronize()
            b, sb = cmk.render_cluster_mega_reference(cms, cam, w, h, **args)
            max_abs3 = max(max_abs3, check_parity(
                f"{name} {w}x{h} {sched}", a.cpu().numpy(), float(sa),
                b.cpu().numpy(), float(sb), w * h))
    cfg, scene, lights, cam, w, h = config_scene(7, dev)
    cms = cmk.build_cluster_megascene(scene, lights)
    kw3 = step_kwargs(cfg)
    saved = cmk.CLUSTER_MEGA_LAUNCHES
    cmk.render_cluster_mega(cms, cam, w, h, **kw3)  # warm-up
    kern_a, (a, sa) = cuda_ms(lambda: cmk.render_cluster_mega(cms, cam, w, h,
                                                              **kw3), 3)
    cmk.WALK_WORK.update(boxes=0, rows=0)
    plain, (b, sb) = cuda_ms(lambda: cmk.render_cluster_mega_reference(
        cms, cam, w, h, **kw3))
    work = dict(cmk.WALK_WORK)
    kern_b, _ = cuda_ms(lambda: cmk.render_cluster_mega(cms, cam, w, h,
                                                        **kw3), 3)
    cmk.CLUSTER_MEGA_LAUNCHES = saved  # comparison launches
    max_abs3 = max(max_abs3, check_parity(
        f"config 7 {w}x{h} {kw3['spp']} spp (regen)", a.cpu().numpy(),
        float(sa), b.cpu().numpy(), float(sb), w * h))
    ms3 = (kern_a + kern_b) / 2
    b_ms, b_by = bound(nbytes(cms.wnodes, cms.tri16, cms.matt, cms.lit)
                       + 19 * 4 + 4 * w * h + 16 * w * h, work["boxes"],
                       work["rows"])
    print(f"  config 7 step: kernel {kern_a:.3f} / {kern_b:.3f} ms, plain "
          f"{plain:.1f} ms; {float(sa):.0f} segments ({float(sa) / ms3 / 1e3:.1f}"
          f" Mrays/s kernel); {work['boxes']} boxes and {work['rows']} rows "
          f"tested -> bound {b_ms:.4f} ms ({b_by}) | {card}")
    out["k3"] = dict(ms=ms3, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     max_abs_err=max_abs3)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    phase(14, "kernel 4 vs its plain version at config 8's own pools "
              "(primary and depth-1 rays of its first step), timed")
    cfg, scene, lights, cam, w, h = config_scene(8, dev)
    spp = max(1, cfg.spp_per_step)
    cl = scene.clusters
    opts = integ.RenderOptions(
        max_depth=cfg.maxdepth, nee=cfg.integrator.nee,
        mis=cfg.integrator.mis,
        russian_roulette=cfg.integrator.russian_roulette,
        rr_start_depth=cfg.integrator.rr_start_depth, resort=True)
    if traverse.resolve_method(scene) != "cluster":
        raise AssertionError("config 8 on CUDA must resolve to the cluster "
                             "kernel")
    # render_batch's first step: tiled pixels, one camera key per sample
    key = rng.fold_in(rng.key(cfg.seed), cfg.seed)
    perm, _ = camera_mod.tile_order(w, h, block=integ.BLKT)
    pix = torch.from_numpy(perm).to(dev)
    pools = [camera_mod.generate_rays_for_pixels(cam, w, h, pix,
                                                 key=rng.split(k)[0])
             for k in rng.split(key, spp)]
    pool0 = RayPool(*(torch.cat(xs) for xs in zip(*pools)))
    del pools
    saved = tk.LAUNCHES
    _, _, ks_ = integ._bounce_keys(key, 0)
    hit = traverse.intersect_scene(scene, pool0.origin, pool0.direction,
                                   active=pool0.alive)
    res = shade_mod.shade(scene.materials, scene.geom.mat_id, pool0, hit,
                          ks_, 0, opts.max_depth,
                          rr_enabled=opts.russian_roulette,
                          rr_start_depth=opts.rr_start_depth, eps=scene.eps)
    bb_lo, inv_ext = integ._scene_box(scene)
    pool1 = integ._resort_pool(res.pool, res.scatter, res.bsdf_pdf,
                               torch.arange(pool0.count, device=dev), bb_lo,
                               inv_ext)[0]
    n_rays = pool0.count
    gen = torch.Generator(device="cpu").manual_seed(14)
    diag = float((scene.geom.verts.reshape(-1, 3).amax(0)
                  - scene.geom.verts.reshape(-1, 3).amin(0)).norm())
    k4 = {}
    max_abs4 = 0.0
    for depth, pool in ((0, pool0), (1, pool1)):
        active = (pool.alive.cpu() & (torch.rand(n_rays, generator=gen)
                                      < 0.85)).to(dev)
        limit = (torch.rand(n_rays, generator=gen) * diag).to(dev)
        o, d = pool.origin.contiguous(), pool.direction.contiguous()
        for any_hit in (False, True):
            lim = limit if any_hit else torch.full_like(limit, 3.0e38)
            args = (cl, o, d, active, lim, any_hit, 1e-4)
            tk._traverse_cuda(*args)  # warm-up
            kern_a, a = cuda_ms(lambda: tk._traverse_cuda(*args), 3)
            cmk.WALK_WORK.update(boxes=0, rows=0)
            plain, b = cuda_ms(lambda: tk.traverse_reference(*args))
            work = dict(cmk.WALK_WORK)
            kern_b, a = cuda_ms(lambda: tk._traverse_cuda(*args), 3)
            pairs = [(a, b)] if any_hit else list(zip(a, b))
            same = all(torch.equal(x, y) for x, y in pairs)
            if not any_hit:
                ok = a[1] >= 0
                max_abs4 = max(max_abs4, float(
                    (a[0][ok] - b[0][ok]).abs().max()) if bool(ok.any())
                    else 0.0)
            ms = (kern_a + kern_b) / 2
            out_bytes = n_rays if any_hit else 20 * n_rays
            b_ms, b_by = bound(nbytes(cl.wnodes, cl.tri16, o, d, active, lim)
                               + out_bytes, work["boxes"], work["rows"])
            what = "any hit" if any_hit else "closest hit"
            n_act = int(active.sum())
            print(f"  depth {depth} {what}: {n_act} of {n_rays} rays active; "
                  f"equal {same}; kernel {kern_a:.3f} / {kern_b:.3f} ms, "
                  f"plain {plain:.1f} ms; {work['boxes']} boxes, "
                  f"{work['rows']} rows -> bound {b_ms:.4f} ms ({b_by}); "
                  f"{n_act / ms / 1e3:.1f} Mrays/s kernel | {card}")
            if not same:
                raise AssertionError(f"kernel 4 disagrees with the plain "
                                     f"version (depth {depth}, {what})")
            k4[(depth, any_hit)] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                        bound_by=b_by)
    tk.LAUNCHES = saved  # comparison launches
    out["k4"] = dict(k4[(0, False)], max_abs_err=max_abs4)
    del pool0, pool1, res, hit
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    phase(15, "oracles on the new engines")
    saved = (cmk.CLUSTER_MEGA_LAUNCHES, tk.LAUNCHES, cmk.LAUNCHES,
             mk.LAUNCHES)
    scene, lights, cms, cam = hybrid_setup("boxfield", 64, 48, dev,
                                           n_boxes=60)
    args = dict(spp=4, seed=21, max_depth=6, rr=True, rr_start=2, nee=True,
                mis=True)
    a, sa = cmk.render_cluster_mega(cms, cam, 64, 48, schedule="batch",
                                    **args)
    for label, (b, sb) in (
            ("megakernel (batch)", mk.render_mega(
                mk.build_megascene(scene, lights), cam, 64, 48,
                schedule="batch", **args)),
            ("hybrid (no compaction)", cmk.render_hybrid(
                cms, cam, 64, 48, compact=None, **args))):
        check_parity(f"boxfield(60) cluster-mega vs {label}, same streams",
                     a.cpu().numpy(), float(sa), b.cpu().numpy(), float(sb),
                     64 * 48)
    scene, lights, _, cam = hybrid_setup("diningroom", 64, 36, dev)
    wopts = integ.RenderOptions(max_depth=4, nee=True, mis=True,
                                russian_roulette=True, rr_start_depth=1,
                                resort=True)
    a, sa = integ.render_batch(scene, lights, cam, 64, 36, rng.key(5), wopts,
                               spp=2, with_stats=True)
    with tk.plain_version_on_cuda():
        b, sb = integ.render_batch(scene, lights, cam, 64, 36, rng.key(5),
                                   wopts, spp=2, with_stats=True)
    check_parity("diningroom 64x36 wavefront (cluster kernel) vs its plain "
                 "version", a.cpu().numpy(), float(sa), b.cpu().numpy(),
                 float(sb), 64 * 36)
    scene, lights, _, cam = hybrid_setup("furnace_sphere", 32, 32, dev,
                                         subdiv=2)
    fopts = integ.RenderOptions(max_depth=8, resort=True)
    method = traverse.resolve_method(scene, fopts.method)
    fb = integ.render(scene, lights, cam, 32, 32, fopts, spp=2, seed=0,
                      spp_per_step=2)
    img = integ.framebuffer_image(fb, 32, 32)
    print(f"furnace ({scene.n_tris} tris, intersector {method}) through the "
          f"wavefront: centre {img[16, 16].tolist()} corner "
          f"{img[1, 1].tolist()}")
    if method != "cluster" or not (np.allclose(img[16, 16], 0.5, atol=1e-5)
                                   and np.allclose(img[1, 1], 1.0,
                                                   atol=1e-5)):
        raise AssertionError("furnace identity fails through the wavefront")
    golden = im.read_exr_rgb(os.path.join(ROOT, "tests", "goldens",
                                          "diningroom.exr"))[::-1]
    scene, lights, cms, cam = hybrid_setup("diningroom", 160, 90, dev)
    gopts = integ.RenderOptions(max_depth=8, nee=True, mis=True, resort=True)
    for label, rad in (
            ("cluster-mega", cmk.render_cluster_mega(
                cms, cam, 160, 90, spp=16, seed=5, max_depth=8, nee=True,
                mis=True)[0]),
            ("wavefront", integ.render_batch(scene, lights, cam, 160, 90,
                                             rng.key(5), gopts, spp=16))):
        img = rad.cpu().numpy().reshape(90, 160, 3) / 16.0
        err = rel_rmse(img.astype(np.float64), golden.astype(np.float64))
        print(f"golden diningroom 160x90 d8 16 spp through {label}: "
              f"rel-RMSE {err:.4f} (gate 0.35)")
        if not err < 0.35:
            raise AssertionError(f"golden gate diningroom ({label}): {err}")
    (cmk.CLUSTER_MEGA_LAUNCHES, tk.LAUNCHES, cmk.LAUNCHES,
     mk.LAUNCHES) = saved  # oracle launches are not main-path launches
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    phase(16, "main path: mcpt_torch.render_cli on configs 7 and 8 through "
              "cluster-mega and the wavefront (16 spp)")
    main_path = {}
    launches = {"cluster-mega": 0, "wavefront": 0}
    with tempfile.TemporaryDirectory() as tmp:
        for cid in (7, 8):
            for engine in ("cluster-mega", "wavefront"):
                cfg_path = write_config_variant(
                    os.path.join(ROOT, "config.json"), cid,
                    os.path.join(tmp, f"config{cid}_{engine}.json"),
                    engine=engine)
                buf = io.StringIO()
                cmk.CLUSTER_MEGA_LAUNCHES = tk.LAUNCHES = 0
                cmk.LAUNCHES = mk.LAUNCHES = 0
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = render_cli.main(["--config", cfg_path, "--configid",
                                          "0", "--out", tmp, "--device",
                                          "cuda", "--spp", "16"])
                wall = time.perf_counter() - t0
                got = {"cluster-mega": cmk.CLUSTER_MEGA_LAUNCHES,
                       "wavefront": tk.LAUNCHES}
                others = cmk.LAUNCHES + mk.LAUNCHES + got[
                    "wavefront" if engine == "cluster-mega"
                    else "cluster-mega"]
                text = buf.getvalue()
                print(text.strip())
                if rc != 0 or f"engine: {engine}" not in text:
                    raise AssertionError(f"config {cid} {engine}: rc {rc}")
                steps = 16 // 4  # configs 7 and 8 render 4 spp a step
                want = steps if engine == "cluster-mega" else 2 * 8 * steps
                print(f"config {cid} {engine}: kernel launches {got[engine]}"
                      f" (expected {want}), other kernels {others}")
                if got[engine] != want or others != 0:
                    raise AssertionError(f"config {cid} {engine}: the CLI "
                                         "did not run through its kernel")
                launches[engine] += got[engine]
                stem = re.search(r"wrote (\S+)\.hdr", text).group(1)
                img = im.read_exr_rgb(os.path.join(tmp, f"{stem}.exr"))
                last = re.findall(r"\|\s*([\d.]+) spp/s \|\s*([\d.]+) "
                                  r"Mrays/s", text)[-1]
                build_s = float(re.search(r"scene build: ([\d.]+) s",
                                          text).group(1))
                method = (re.search(r"intersector (\w+) \|", text).group(1)
                          if engine == "wavefront" else "cluster walk")
                main_path[f"config {cid} {engine}"] = dict(
                    spp_per_s=float(last[0]), mrays=float(last[1]),
                    wall_s=wall, mean=float(img.mean()), build_s=build_s,
                    method=method)
                print(f"config {cid} {engine}: scene build {build_s:.2f} s, "
                      f"intersector {method}, {last[1]} Mrays/s, {last[0]} "
                      f"spp/s, wall {wall:.2f} s, image mean "
                      f"{img.mean():.4f} | {card}")
                if not np.isfinite(img).all() or not img.mean() > 0.0:
                    raise AssertionError(f"config {cid} {engine}: non-finite"
                                         " or black image")
                if engine == "wavefront" and method != "cluster":
                    raise AssertionError("the wavefront did not resolve to "
                                         "the cluster kernel")
    out["launches3"] = launches["cluster-mega"]
    out["launches4"] = launches["wavefront"]
    out["main_path3"] = main_path
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return out


def device_activity(prof):
    """From a ``torch.profiler`` trace: (µs during which the card ran
    something — the union of its kernel, copy and set intervals —, {name:
    (µs, count)} of those activities)."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, by_name


def engine_ab(spp: int = 64, step: int = 4, prof_steps: int = 2) -> None:
    """``--engine-ab``: the three large-scene engines on configs 7 and 8 at
    their own size, each through its kernels: after a warm-up step,
    ``spp`` samples in steps of ``step`` (Mrays/s, spp/s by the host clock
    around synchronised work), then ``torch.profiler`` over ``prof_steps``
    steps: the device's busy share of the window and the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mcpt_torch import rng
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.render import integrator as integ

    dev = torch.device("cuda")
    card = smi()
    print(f"nvidia-smi: {card}")
    for cid in (7, 8):
        cfg, scene, lights, cam, w, h = config_scene(cid, dev)
        cms = cmk.build_cluster_megascene(scene, lights)
        kw = step_kwargs(cfg)
        del kw["spp"], kw["seed"]
        opts = integ.RenderOptions(
            max_depth=kw["max_depth"], nee=kw["nee"], mis=kw["mis"],
            russian_roulette=kw["rr"], rr_start_depth=kw["rr_start"],
            resort=True)
        compact = integ.measure_hybrid_schedule(cms, cam, opts)
        base = rng.key(cfg.seed)
        engines = {
            "hybrid": lambda s, seed: cmk.render_hybrid(
                cms, cam, w, h, spp=s, seed=seed, compact=compact, **kw),
            "cluster-mega": lambda s, seed: cmk.render_cluster_mega(
                cms, cam, w, h, spp=s, seed=seed, **kw),
            "wavefront": lambda s, seed: integ.render_batch(
                scene, lights, cam, w, h, rng.fold_in(base, seed), opts,
                spp=s, with_stats=True),
        }
        for name, render in engines.items():
            render(step, cfg.seed)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            segs = 0.0
            for i in range(spp // step):
                segs += float(render(step, cfg.seed + i * step * 7919)[1])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                for i in range(prof_steps):
                    render(step, cfg.seed + i * 7919)
                torch.cuda.synchronize()
                window = time.perf_counter() - t1
            busy_us, by_name = device_activity(prof)
            print(f"config {cid} {w}x{h} {name}: {segs / dt / 1e6:.2f} "
                  f"Mrays/s, {spp / dt:.2f} spp/s ({spp} spp in {dt:.3f} s, "
                  f"{segs:.0f} segments); profiler: device busy "
                  f"{busy_us / 1e6 / window:.1%} of {window * 1e3:.2f} ms "
                  f"over {prof_steps} steps | {card}")
            ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
            # the top six, and the port's own kernels wherever they rank
            for i, (key, (us, count)) in enumerate(ranked):
                if i < 6 or "mcpt::" in key:
                    print(f"    {us / 1e3:9.2f} ms  {us / 1e4 / window:5.1f}%"
                          f"  {count:6d}x  {key[:90]}")


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
        compact = integ.measure_hybrid_schedule(cms, cam, opts)
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
    ap.add_argument("--engine-ab", action="store_true",
                    help="only time the three large-scene engines (hybrid, "
                         "cluster-mega, wavefront) on configs 7 and 8 at 64 "
                         "spp, with a torch.profiler window each")
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
        if args.engine_ab:
            engine_ab()
            return 0
        report = run()
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(report["card"])
    hy = report["hybrid"]
    kernels = [
        dict(name="render_mega", source="mcpt_torch/csrc/megakernel.cu",
             replaces="mcpt/pallas/megakernel.py:1168",
             launches=report["launches"], **{k: report[k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}),
        dict(name="fused_bounce", source="mcpt_torch/csrc/fused_bounce.cu",
             replaces="mcpt/pallas/cluster_megakernel.py:586",
             launches=hy["launches"], **{k: hy[k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}),
        dict(name="render_cluster_mega",
             source="mcpt_torch/csrc/cluster_mega.cu",
             replaces="mcpt/pallas/cluster_megakernel.py:418",
             launches=report["launches3"], **report["k3"]),
        dict(name="traverse", source="mcpt_torch/csrc/traverse.cu",
             replaces="mcpt/pallas/traverse_kernel.py:333",
             launches=report["launches4"], **report["k4"]),
    ]
    # no single PyTorch call computes a path or a closest hit
    print(json.dumps({"kernels": [dict(k, route="cuda", library_ms=None)
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
