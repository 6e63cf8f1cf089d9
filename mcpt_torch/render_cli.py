#!/usr/bin/env python
"""Progressive render CLI — the port's counterpart of ``tools/render.py``.

Same flags, seed schedule, progress line, snapshots, checkpoints and output
files (``<stem>.hdr/.png/.exr``), plus ``--device`` (default ``cuda``).  The
engines are ``tools/render.py``'s: the dense megakernel (``mega``), the
hybrid fused-bounce engine (``hybrid``), the cluster megakernel
(``cluster-mega``) and, for every other engine name, the wavefront
integrator (``integrator.render_batch``, threefry-keyed as ``mcpt`` keys
it).  ``engine`` ``auto`` takes the megakernel up to ``MEGA_MAX_TRIS``
triangles and the hybrid past it.  On CUDA the hybrid first runs its pilot
(``integrator.measure_hybrid_schedule``) for the pool compaction caps.  The
wavefront takes the config's ``intersector`` and re-sorts its pool between
bounces with ``--resort on`` (``auto``: when the intersector resolves to
``cluster``, i.e. a clustered scene on CUDA).  A config's ``mesh`` renders
single-device when one device is visible.  ``testbvh``/``testall`` and a
``mesh`` over several devices raise ``NotImplementedError`` naming their
ROADMAP item.

Usage:
    python -m mcpt_torch.render_cli [--config PATH] [--configid N] [--spp N]
        [--out DIR] [--snapshot-every N] [--checkpoint-every N] [--resume]
        [--resort auto|on|off] [--profile] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import torch

# mcpt modes not ported yet → their ROADMAP items (Queue 1)
_NOT_PORTED = {
    "testbvh": "Queue 1 item 12 (Slice 4: the BVH quality harness)",
    "mesh": "Queue 1 item 13 (Slice 5: sharded rendering)",
}
# engine "auto": the dense megakernel up to this many triangles, the hybrid
# past it.  The H100's crossover, measured by `python3 chip_smoke.py
# --crossover` (PERF.md §5): the megakernel wins at 1564 tris (573 vs 377
# Mrays/s), the hybrid at 1804 (426 vs 287).
MEGA_MAX_TRIS = 1700


def build_from_config(cfg, device):
    """Config → (Scene, Lights, CameraConfig) on ``device``: a procedural
    builder for ``procedural:<name>``, else the .obj in ``directory``."""
    from mcpt_torch import scenes as procedural
    from mcpt_torch.io.objloader import load_object
    from mcpt_torch.scene import build_scene

    name = cfg.objname if isinstance(cfg.objname, str) else cfg.objnames[0]
    if name.startswith("procedural:"):
        builder = getattr(procedural, name.split(":", 1)[1])
        loaded, cam_default = builder()
        cam_cfg = cfg.camera or cam_default
    else:
        loaded = load_object(cfg.directory, name)
        cam_cfg = cfg.camera
        if cam_cfg is None:
            raise SystemExit("config has no camera block")
    scene, lights = build_scene(loaded, cfg.bvhtype, device=device)
    return scene, lights, cam_cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="config.json")
    ap.add_argument("--configid", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None, help="override 'attempt'")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="write a progressive PNG every N samples")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save (sum, count) every N samples for --resume")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint in --out")
    ap.add_argument("--resort", choices=["auto", "on", "off"], default="auto",
                    help="inter-bounce ray re-sorting (Morton/octant) of the "
                         "wavefront engine; auto = on when its intersector "
                         "resolves to the cluster kernel")
    ap.add_argument("--profile", action="store_true",
                    help="per-stage timing report at exit (StageTimer); the "
                         "hybrid engine also prints a per-bounce "
                         "bounce/sort/roulette/reduce breakdown of one "
                         "instrumented step")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the CUDA kernels, cpu the "
                         "plain PyTorch versions")
    args = ap.parse_args(argv)

    from mcpt_torch import rng, runtime
    from mcpt_torch.config import load_config
    from mcpt_torch.convert import load_checkpoint, save_checkpoint
    from mcpt_torch.io import image as im
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.kernels import megakernel as mk
    from mcpt_torch.render import camera as camera_mod
    from mcpt_torch.render import integrator as integ
    from mcpt_torch.render import traverse
    from mcpt_torch.types import make_framebuffer

    cfg = load_config(args.config, args.configid)
    if cfg.testall or cfg.testbvh:
        raise NotImplementedError(
            "testbvh/testall (the BVH quality harness) is not ported yet: "
            f"ROADMAP {_NOT_PORTED['testbvh']}")
    device = torch.device(args.device)
    if cfg.mesh:
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        if n_dev > 1:
            raise NotImplementedError(
                f"config 'mesh' over {n_dev} devices (sharded rendering) is "
                f"not ported yet: ROADMAP {_NOT_PORTED['mesh']}")
        print("config requests a device mesh but only one device is "
              "visible — rendering single-chip")

    t_build = time.perf_counter()
    scene, lights, cam_cfg = build_from_config(cfg, device)
    t_build = time.perf_counter() - t_build
    width = args.width or cfg.width or cam_cfg.resolution[0]
    height = args.height or cfg.height or cam_cfg.resolution[1]
    if cam_cfg.resolution != (width, height):
        cam_cfg = dataclasses.replace(cam_cfg, resolution=(width, height))
    spp = args.spp or cfg.attempt or 64
    cam = camera_mod.make_camera(cam_cfg, device=device)

    opts = integ.RenderOptions(
        max_depth=cfg.maxdepth or 16,
        nee=cfg.integrator.nee,
        mis=cfg.integrator.mis,
        russian_roulette=cfg.integrator.russian_roulette,
        rr_start_depth=cfg.integrator.rr_start_depth,
        method=cfg.intersector,
    )
    stem = (cfg.output_stem or "render").replace("procedural:", "")
    os.makedirs(args.out, exist_ok=True)
    ckpt_path = os.path.join(args.out, f"{stem}.ckpt.npz")

    fb = make_framebuffer(width * height, device)
    start_s = 0
    if args.resume and os.path.exists(ckpt_path):
        fb, start_s = load_checkpoint(ckpt_path, device)
        print(f"resumed at {start_s} spp from {ckpt_path}")

    print(runtime.device_info(device))
    print(
        f"scene: {scene.n_tris} tris, {lights.count} light tris | "
        f"{width}x{height} @ {spp} spp, depth {opts.max_depth}, "
        f"nee={opts.nee} mis={opts.mis} rr={opts.russian_roulette} "
        f"intersector={opts.method} bvh={cfg.bvhtype} | device={device}"
    )
    print(f"scene build: {t_build:.2f} s")

    engine = cfg.engine
    if engine == "auto":
        engine = "mega" if scene.n_tris <= MEGA_MAX_TRIS else "hybrid"
    step_kw = dict(max_depth=opts.max_depth, rr=opts.russian_roulette,
                   rr_start=opts.rr_start_depth, nee=opts.nee, mis=opts.mis,
                   clamp=cfg.integrator.clamp)
    if engine == "mega":
        mega = mk.build_megascene(scene, lights)

        def render_step(seed_step, step):
            return mk.render_mega(mega, cam, width, height, spp=step,
                                  seed=seed_step, **step_kw)
    elif engine == "hybrid":
        cms = cmk.build_cluster_megascene(scene, lights)
        if device.type == "cuda":
            # the pilot's unbiased pool compaction (tools/render.py:211-217)
            step_kw["compact"] = integ.measure_hybrid_schedule(cms, cam, opts)
        print(f"hybrid: {cms.n_clusters} clusters, {cms.wnodes.shape[0]} "
              f"wide nodes | pilot caps {step_kw.get('compact')} | key mode "
              f"{cmk.resolve_key_mode('auto', step_kw.get('compact'))}")

        def render_step(seed_step, step):
            return cmk.render_hybrid(cms, cam, width, height, spp=step,
                                     seed=seed_step, **step_kw)
    elif engine == "cluster-mega":
        cms = cmk.build_cluster_megascene(scene, lights)
        print(f"cluster-mega: {cms.n_clusters} clusters, "
              f"{cms.wnodes.shape[0]} wide nodes")

        def render_step(seed_step, step):
            return cmk.render_cluster_mega(cms, cam, width, height, spp=step,
                                           seed=seed_step, **step_kw)
    else:
        # every other engine name is the wavefront (tools/render.py:252-268)
        method = traverse.resolve_method(scene, opts.method)
        if args.resort == "on" or (args.resort == "auto"
                                   and method == "cluster"):
            opts = opts._replace(resort=True)
        print(f"wavefront: intersector {method} | resort "
              f"{'on' if opts.resort else 'off'}")
        base_key = rng.key(cfg.seed)

        def render_step(seed_step, step):
            return integ.render_batch(scene, lights, cam, width, height,
                                      rng.fold_in(base_key, seed_step), opts,
                                      spp=step, with_stats=True)

    print(f"engine: {engine}")
    t0 = time.time()
    t_last, s_last = t0, start_s
    step_size = max(1, cfg.spp_per_step)
    done = start_s
    timer = runtime.StageTimer() if args.profile else None
    # measured Mrays/s: live segments (closest-hit queries on live paths +
    # NEE shadow rays), counted by the kernel itself
    segs_done, segs_last = 0.0, 0.0
    snap_last, ckpt_last = done, done
    while done < spp:
        step = min(step_size, spp - done)
        if timer is not None:
            with timer.stage("render_step"):
                radiance, segs = render_step(cfg.seed + done * 7919, step)
                timer.sync(radiance, segs)
            with timer.stage("accumulate"):
                fb = integ.accumulate(fb, radiance, spp=step)
                timer.sync(fb.sum)
        else:
            radiance, segs = render_step(cfg.seed + done * 7919, step)
            fb = integ.accumulate(fb, radiance, spp=step)
        done += step
        segs_done += float(segs)  # waits for the step (device scalar read)
        now = time.time()
        if now - t_last > 2.0 or done == spp:
            runtime.StageTimer.sync(fb.sum)
            now = time.time()
            sps = (done - s_last) / max(now - t_last, 1e-9)
            rays = runtime.mrays(segs_done - segs_last, now - t_last)
            print(
                f"  {done}/{spp} spp | {sps:6.2f} spp/s | "
                f"{rays:8.2f} Mrays/s | {now - t0:6.1f}s elapsed",
                flush=True,
            )
            t_last, s_last = now, done
            segs_last = segs_done
        if (args.snapshot_every and done - snap_last >= args.snapshot_every
                and done < spp):
            snap_last = done
            img = integ.framebuffer_image(fb, width, height)
            im.write_png(os.path.join(args.out, f"{stem}.png"),
                         im.tonemap_srgb(img[::-1]))
        if args.checkpoint_every and done - ckpt_last >= args.checkpoint_every:
            ckpt_last = done
            save_checkpoint(ckpt_path, fb, done)

    img = integ.framebuffer_image(fb, width, height)
    # final outputs: .hdr like the reference (colorout.cpp:63-68) + png + exr
    with (timer.stage("image_io") if timer is not None
          else contextlib.nullcontext()):
        im.write_hdr(os.path.join(args.out, f"{stem}.hdr"), img)
        im.write_png(os.path.join(args.out, f"{stem}.png"),
                     im.tonemap_srgb(img[::-1]))
        im.write_exr(os.path.join(args.out, f"{stem}.exr"), img[::-1])
    print("Finished Attempting")  # parity with colorout.cpp:65
    print(f"wrote {stem}.hdr/.png/.exr in {args.out}")
    if timer is not None:
        print("\nprofile: CLI stage totals (the first render_step includes "
              "the kernel build)")
        print(timer.report())
        if engine == "hybrid":
            print("\nprofile: hybrid per-bounce breakdown (one instrumented "
                  "step after a warm-up one)")
            prof_kw = dict(step_kw, spp=min(step_size, spp),
                           seed=cfg.seed + (spp + 1) * 7919)
            cmk.profile_hybrid(cms, cam, width, height, **prof_kw)
            t2, _, _ = cmk.profile_hybrid(cms, cam, width, height, **prof_kw)
            print(t2.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
