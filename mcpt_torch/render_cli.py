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
``cluster``, i.e. a clustered scene on CUDA).  A ``testbvh`` or
``testall`` entry runs the BVH quality harness (``mcpt_torch.bvh_bench``)
on ``--device``, as ``tools/render.py:82-91`` does.

A config's ``mesh`` (``{"samples": s, "pixels": p}``) renders sharded when
the CLI runs as several ranks under ``torchrun``: the mesh spans the world
(``mcpt_torch.dist``), every engine goes through its sharded twin, each
step renders a multiple of the samples axis (the request rounds up once),
and rank 0 prints and writes the files.  Ranks with a card each join over
``nccl``, ranks sharing a card over ``gloo``.  With one process a ``mesh``
renders on one device; several ranks without a ``mesh`` raise (each would
render the same image).

Usage:
    python -m mcpt_torch.render_cli [--config PATH] [--configid N] [--spp N]
        [--out DIR] [--snapshot-every N] [--checkpoint-every N] [--resume]
        [--resort auto|on|off] [--profile] [--device cuda|cpu]
    torchrun --nproc-per-node N -m mcpt_torch.render_cli --configid 9
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import sys
import time

import torch

# engine "auto": the dense megakernel up to this many triangles, the hybrid
# past it.  The H100's crossover, measured by `python3 chip_smoke.py
# --crossover` (PERF.md §5): the megakernel wins at 1564 tris (573 vs 377
# Mrays/s), the hybrid at 1804 (426 vs 287).
MEGA_MAX_TRIS = 1700
# --profile: steps traced after the first one (which loads the kernels)
PROFILE_STEPS = 4


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


def _world_size() -> int:
    """Ranks of this run: the default group's, else ``torchrun``'s
    ``WORLD_SIZE``, else 1."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


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
                    help=f"run the {PROFILE_STEPS} steps after the first "
                         "under torch.profiler, unsynchronised, and print "
                         "the engine's mcpt. spans (calls, host, device and "
                         "idle ms a step) and the card's busy share")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the CUDA kernels, cpu the "
                         "plain PyTorch versions")
    args = ap.parse_args(argv)

    from mcpt_torch.config import load_config

    cfg = load_config(args.config, args.configid)
    if cfg.testall or cfg.testbvh:
        # mode dispatch parity with main.cpp:12-19
        from mcpt_torch import bvh_bench

        return bvh_bench.run_from_config(cfg, args.device)
    device = torch.device(args.device)
    world = _world_size()
    if world == 1:
        if cfg.mesh:
            print("config requests a device mesh but only one device is "
                  "visible — rendering single-chip")
        return _render(args, cfg, device)
    if not cfg.mesh:
        raise ValueError(f"{world} ranks and no 'mesh' in the config: every "
                         "rank would render the same image")
    import torch.distributed as tdist

    from mcpt_torch import dist

    owned = not tdist.is_initialized()
    backend, device = dist.init_world(device)
    try:
        mesh = dist.make_mesh(samples=int(cfg.mesh.get("samples", 1)),
                              pixels=int(cfg.mesh.get("pixels", 0)) or None)
        shared = (f" ({world} ranks share {torch.cuda.device_count()} "
                  "card(s))" if backend == "gloo" and device.type == "cuda"
                  else "")
        header = (f"mesh: {mesh.shape} over {world} ranks | backend "
                  f"{backend}{shared}")
        if tdist.get_rank() != 0:  # rank 0 prints and writes the files
            with contextlib.redirect_stdout(io.StringIO()):
                return _render(args, cfg, device, mesh, header)
        return _render(args, cfg, device, mesh, header)
    finally:
        if owned:
            tdist.destroy_process_group()


def _render(args, cfg, device, mesh=None, mesh_header=None) -> int:
    """The render of ``main``: single-device, or sharded over ``mesh``."""
    from mcpt_torch import rng, runtime
    from mcpt_torch.convert import load_checkpoint, save_checkpoint
    from mcpt_torch.io import image as im
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.kernels import megakernel as mk
    from mcpt_torch.render import camera as camera_mod
    from mcpt_torch.render import integrator as integ
    from mcpt_torch.render import traverse
    from mcpt_torch.trace import span
    from mcpt_torch.types import make_framebuffer

    writer = mesh is None or mesh.si == mesh.pi == 0
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
    if mesh_header:
        print(mesh_header)
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
    if mesh is not None:
        from mcpt_torch import dist

        step_kw["mesh"] = mesh
    if engine == "mega":
        mega = mk.build_megascene(scene, lights)
        render_mega = (mk.render_mega if mesh is None
                       else dist.render_mega_sharded)

        def render_step(seed_step, step):
            return render_mega(mega, cam, width, height, spp=step,
                               seed=seed_step, **step_kw)
    elif engine == "hybrid":
        cms = cmk.build_cluster_megascene(scene, lights)
        if device.type == "cuda":
            # the pilot's unbiased pool compaction (tools/render.py:211-217)
            step_kw["compact"] = integ.measure_hybrid_schedule(cms, cam, opts)
        print(f"hybrid: {cms.n_clusters} clusters, {cms.wnodes.shape[0]} "
              f"wide nodes | pilot caps {step_kw.get('compact')} | key mode "
              f"{cmk.resolve_key_mode('auto', step_kw.get('compact'))}")
        render_hybrid = (cmk.render_hybrid if mesh is None
                         else dist.render_hybrid_sharded)

        def render_step(seed_step, step):
            return render_hybrid(cms, cam, width, height, spp=step,
                                 seed=seed_step, **step_kw)
    elif engine == "cluster-mega":
        cms = cmk.build_cluster_megascene(scene, lights)
        print(f"cluster-mega: {cms.n_clusters} clusters, "
              f"{cms.wnodes.shape[0]} wide nodes")
        render_cluster = (cmk.render_cluster_mega if mesh is None
                          else dist.render_cluster_sharded)

        def render_step(seed_step, step):
            return render_cluster(cms, cam, width, height, spp=step,
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
            key = rng.fold_in(base_key, seed_step)
            if mesh is not None:
                return dist.render_batch_sharded(
                    scene, lights, cam, width, height, key, opts, step, mesh,
                    with_stats=True)
            return integ.render_batch(scene, lights, cam, width, height, key,
                                      opts, spp=step, with_stats=True)

    print(f"engine: {engine}")
    t0 = time.time()
    t_last, s_last = t0, start_s
    step_size = max(1, cfg.spp_per_step)
    if mesh is not None:
        # every sharded step renders a samples-axis multiple
        d_s = mesh.shape["samples"]
        step_size = max(d_s, (step_size // d_s) * d_s)
        if spp % d_s:
            spp = ((spp + d_s - 1) // d_s) * d_s
            print(f"spp rounded up to {spp} (samples axis = {d_s})")
    done = start_s
    n_steps, prof = 0, None
    # measured Mrays/s: live segments (closest-hit queries on live paths +
    # NEE shadow rays), counted by the kernel itself
    segs_done, segs_last = 0.0, 0.0
    snap_last, ckpt_last = done, done
    while done < spp:
        step = min(step_size, spp - done)
        if args.profile and n_steps == 1:
            prof = _profile_start(device)
        radiance, segs = render_step(cfg.seed + done * 7919, step)
        fb = integ.accumulate(fb, radiance, spp=step)
        done += step
        with span("mcpt.wait.segments"):
            segs_done += float(segs)  # waits for the step
        n_steps += 1
        if prof is not None and (n_steps > PROFILE_STEPS or done == spp):
            _profile_stop(prof, device, n_steps - 1)
            prof = None
        now = time.time()
        if now - t_last > 2.0 or done == spp:
            if device.type == "cuda" and prof is None:
                torch.cuda.synchronize(device)
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
            if writer:
                img = integ.framebuffer_image(fb, width, height)
                im.write_png(os.path.join(args.out, f"{stem}.png"),
                             im.tonemap_srgb(img[::-1]))
        if args.checkpoint_every and done - ckpt_last >= args.checkpoint_every:
            ckpt_last = done
            if writer:
                save_checkpoint(ckpt_path, fb, done)

    print(f"segments: {segs_done:.0f} in {done - start_s} spp")
    img = integ.framebuffer_image(fb, width, height)
    # final outputs: .hdr like the reference (colorout.cpp:63-68) + png + exr
    if writer:
        im.write_hdr(os.path.join(args.out, f"{stem}.hdr"), img)
        im.write_png(os.path.join(args.out, f"{stem}.png"),
                     im.tonemap_srgb(img[::-1]))
        im.write_exr(os.path.join(args.out, f"{stem}.exr"), img[::-1])
    print("Finished Attempting")  # parity with colorout.cpp:65
    print(f"wrote {stem}.hdr/.png/.exr in {args.out}")
    if args.profile and n_steps < 2:
        print("profile: no step after the first to trace")
    return 0


def _profile_start(device):
    """A ``torch.profiler`` session over the host and, on CUDA, the card,
    started now."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _profile_stop(prof, device, steps: int) -> None:
    """Stop ``prof`` once the card is done and print its ``mcpt.`` spans
    over its ``steps`` steps."""
    import warnings

    from mcpt_torch import trace

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with warnings.catch_warnings():
        # one profiling cycle: its "clears events" notice does not apply
        warnings.simplefilter("ignore", UserWarning)
        prof.stop()
    print(trace.report(prof, steps), flush=True)


if __name__ == "__main__":
    sys.exit(main())
