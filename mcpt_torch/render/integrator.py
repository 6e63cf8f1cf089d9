"""The wavefront path-tracing integrator, framebuffer accumulation and the
pilots (the port of ``mcpt/render/integrator.py``).

The wavefront engine keeps one flat pool of rays, one per (sample, pixel),
and runs ``max_depth`` times {intersect → shade → NEE shadow ray}
(``trace``), optionally re-sorting the pool between bounces for coherence
(``resort``) or shrinking it to its live paths (``trace_compacted``).
``render_batch`` follows ``mcpt``'s key schedule exactly: its threefry
draws (``mcpt_torch.rng``) are ``jax.random``'s bits, so the same seed gives
the same pixels.  On a clustered scene on CUDA the intersections go through
kernel 4 (``kernels/traverse_kernel``), twice a bounce.

Random numbers per bounce: ``split(fold_in(key, depth), 3)`` → (unused,
NEE, shade) in ``trace``, (NEE, shade, compaction) in ``trace_compacted``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcpt_torch import rng
from mcpt_torch.kernels import _build
from mcpt_torch.render import camera as camera_mod
from mcpt_torch.render import shade as shade_mod
from mcpt_torch.render import traverse
from mcpt_torch.render.traverse import dot
from mcpt_torch.trace import span, spanned
from mcpt_torch.types import Framebuffer, RayPool

DEAD_KEY = 0x7FFFFFFF  # resort key of a dead ray: dead rays sort last
BLKT = 32 * 128  # tile size of the cluster method's pixel order (mcpt's)


class RenderOptions(NamedTuple):
    """Integrator options (``mcpt.render.integrator.RenderOptions``)."""

    max_depth: int = 16
    nee: bool = False
    mis: bool = False
    russian_roulette: bool = False
    rr_start_depth: int = 3
    method: str = "auto"  # intersector: auto | brute | bvh | cluster
    jitter: bool = True
    # bounce loop: "fori" and "unroll" run every depth; "while" stops once
    # every path is dead (the same result)
    loop: str = "fori"
    # per-depth live-fraction caps of the pool (entry d caps the pool
    # entering bounce d+1); None traces the full pool every bounce
    compact: tuple | None = None
    # re-sort the pool between bounces by origin cell, octant and fine
    # origin (dead rays last); the ray order is restored after the loop
    resort: bool = False
    resort_coarse_bits: int = 6


def accumulate(fb: Framebuffer, radiance_sum, spp: int = 1) -> Framebuffer:
    """Exact running (sum, count): every sample counts (unbiased mean)."""
    with span("mcpt.accumulate"):
        return Framebuffer(sum=fb.sum + radiance_sum,
                           count=fb.count + float(spp))


def framebuffer_image(fb: Framebuffer, width: int, height: int) -> np.ndarray:
    """(H, W, 3) float32 mean radiance on the host, row 0 at the *bottom*
    (the reference framebuffer orientation; flip when writing images)."""
    return fb.mean.detach().cpu().numpy().reshape(height, width, 3)


@spanned("mcpt.wavefront.nee")
def _nee_contribution(scene, lights, res: shade_mod.ShadeResult, hit_point,
                      wo, key: rng.Key, opts: RenderOptions) -> torch.Tensor:
    """One area-uniform light sample per ray, its shadow ray and the MIS
    weight → (R, 3) radiance delta (before the path throughput)."""
    r = hit_point.shape[0]
    u = rng.uniform(key, (r, 3), hit_point.device)
    li = torch.clamp(torch.searchsorted(lights.cdf, u[:, 0].contiguous(),
                                        right=False), 0, lights.count - 1)
    tri = lights.tri[li].long()
    v = scene.geom.verts[tri]  # (R, 3, 3)
    su = torch.sqrt(u[:, 1])
    b0 = 1.0 - su
    b1 = su * (1.0 - u[:, 2])
    b2 = su * u[:, 2]
    p_l = (b0[:, None] * v[:, 0] + b1[:, None] * v[:, 1]
           + b2[:, None] * v[:, 2])
    n_l = scene.geom.normals[tri]

    to_l = p_l - hit_point
    dist2 = dot(to_l, to_l)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    wi = to_l / dist[:, None]
    cos_surf = dot(res.n_shade, wi)
    cos_light = dot(n_l, wi).abs()  # lights emit on both sides
    pdf_sa = dist2 / torch.clamp(cos_light * lights.total_area, min=1e-12)
    f, bsdf_pdf = shade_mod.eval_bsdf(scene.materials, res.mat_id,
                                      res.n_shade, wo, wi)

    cand = res.scatter & (cos_surf > 0.0) & (cos_light > 1e-6)
    shadow_o = hit_point + scene.eps * wi
    blocked = traverse.occluded(scene, shadow_o, wi,
                                dist - 2.0 * scene.eps, active=cand,
                                method=opts.method)
    vis = cand & ~blocked
    le = lights.emission[li]
    if opts.mis:
        w_mis = pdf_sa * pdf_sa / torch.clamp(
            pdf_sa * pdf_sa + bsdf_pdf * bsdf_pdf, min=1e-20)
    else:
        w_mis = torch.ones_like(pdf_sa)
    contrib = f * le * (cos_surf * w_mis
                        / torch.clamp(pdf_sa, min=1e-12))[:, None]
    return torch.where(vis[:, None], contrib, 0.0)


def _emission_scale(hit, pool: RayPool, lights, prev_scatter, prev_pdf,
                    opts: RenderOptions):
    """MIS discount of a light hit after a scatter bounce (NEE-only: 0)."""
    cos_l = dot(hit.normal, pool.direction).abs()
    pdf_light_sa = hit.t * hit.t / torch.clamp(cos_l * lights.total_area,
                                               min=1e-12)
    if opts.mis:
        w = prev_pdf * prev_pdf / torch.clamp(
            prev_pdf * prev_pdf + pdf_light_sa * pdf_light_sa, min=1e-20)
    else:
        w = torch.zeros_like(prev_pdf)
    return torch.where(prev_scatter, w, 1.0)


def _scene_box(scene):
    """(lo, 1 / extent) of the scene's vertices, in float32."""
    v = scene.geom.verts.reshape(-1, 3)
    bb_lo = v.amin(dim=0)
    ext = v.amax(dim=0) - bb_lo
    return bb_lo, 1.0 / torch.clamp(ext, min=1e-12)


@spanned("mcpt.wavefront.resort_keys")
def _sort_key(pool: RayPool, bb_lo, inv_ext, coarse_bits: int = 6):
    """Coherence key (< 2³⁰): coarse origin cell (``coarse_bits`` Morton
    bits), direction octant, fine origin Morton bits."""
    from mcpt_torch.bvh.lbvh import morton30

    u = torch.clamp((pool.origin - bb_lo) * inv_ext, 0.0, 0.999999)
    m = morton30(u)
    d = pool.direction
    octant = ((d[:, 0] > 0).to(torch.int64) + 2 * (d[:, 1] > 0).to(torch.int64)
              + 4 * (d[:, 2] > 0).to(torch.int64))
    fine_bits = min(30 - coarse_bits, 12)
    coarse = m >> (30 - coarse_bits)
    fine = (m >> (30 - coarse_bits - fine_bits)) & ((1 << fine_bits) - 1)
    return (coarse << (3 + fine_bits)) | (octant << fine_bits) | fine


@spanned("mcpt.wavefront.resort")
def _resort_pool(pool: RayPool, prev_scatter, prev_pdf, orig_idx, bb_lo,
                 inv_ext, coarse_bits: int = 6):
    """The pool stably sorted by ``_sort_key``, dead rays last: one stable
    sort, then one gather of every field."""
    key = torch.where(pool.alive, _sort_key(pool, bb_lo, inv_ext,
                                            coarse_bits), DEAD_KEY)
    order = torch.sort(key, stable=True).indices
    return (RayPool(*(x[order] for x in pool)), prev_scatter[order],
            prev_pdf[order], orig_idx[order])


def _bounce_keys(key: rng.Key, depth: int):
    return rng.split(rng.fold_in(key, depth), 3)


def trace(scene, lights, pool: RayPool, key: rng.Key, opts: RenderOptions,
          with_stats: bool = False):
    """The bounce loop → the final pool (radiance set), and with
    ``with_stats`` the live segments traced (closest-hit queries on live
    paths plus NEE shadow rays) as a float64 0-d tensor."""
    r = pool.count
    dev = pool.origin.device
    use_nee = opts.nee and lights.count > 0
    if opts.resort:
        bb_lo, inv_ext = _scene_box(scene)
    prev_scatter = torch.zeros((r,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((r,), dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.float64, device=dev)
    orig_idx = torch.arange(r, device=dev)
    if opts.loop not in ("fori", "unroll", "while"):
        raise ValueError(f"unknown loop mode {opts.loop!r}")

    # the cluster kernel's overflow flag is read once, after the loop
    with _build.overflow_checked_once():
        for depth in range(opts.max_depth):
            if opts.loop == "while" and not bool(pool.alive.any()):
                break
            _, kn_, ks_ = _bounce_keys(key, depth)
            hit = traverse.intersect_scene(
                scene, pool.origin, pool.direction, active=pool.alive,
                method=opts.method)
            e_scale = (_emission_scale(hit, pool, lights, prev_scatter,
                                       prev_pdf, opts) if use_nee else None)
            wo = -pool.direction
            res = shade_mod.shade(
                scene.materials, scene.geom.mat_id, pool, hit, ks_, depth,
                opts.max_depth, rr_enabled=opts.russian_roulette,
                rr_start_depth=opts.rr_start_depth, emission_scale=e_scale,
                eps=scene.eps)
            new_pool = res.pool
            segments = segments + pool.alive.sum()
            if use_nee:
                delta = _nee_contribution(scene, lights, res, hit.point, wo,
                                          kn_, opts)
                # NEE carries the throughput from before this bounce's weight
                new_pool = new_pool._replace(
                    radiance=new_pool.radiance + pool.throughput * delta)
                segments = segments + res.scatter.sum()
            prev_scatter, prev_pdf = res.scatter, res.bsdf_pdf
            if opts.resort:
                new_pool, prev_scatter, prev_pdf, orig_idx = _resort_pool(
                    new_pool, prev_scatter, prev_pdf, orig_idx, bb_lo,
                    inv_ext, opts.resort_coarse_bits)
            pool = new_pool
    if opts.resort:
        # back to the original ray order (the ids are a permutation)
        order = torch.argsort(orig_idx)
        pool = pool._replace(radiance=pool.radiance[order],
                             pixel=pool.pixel[order])
    return (pool, segments) if with_stats else pool


def _round_up(n: int, mult: int = 1024) -> int:
    return ((n + mult - 1) // mult) * mult


def _compact_pool(pool: RayPool, prev_scatter, prev_pdf, key: rng.Key,
                  cap: int):
    """The pool shrunk to a live prefix of ``cap`` rows.  With more than
    ``cap`` live paths, exactly ``cap`` survivors are drawn uniformly (rank
    of a random score) and scaled by 1/p: unbiased under any schedule."""
    r = pool.count
    dev = pool.origin.device
    live = pool.alive.to(torch.int32).sum()
    n_keep = torch.clamp(live, max=cap)
    p_keep = n_keep.to(torch.float32) / torch.clamp(
        live.to(torch.float32), min=1.0)
    u = rng.uniform(key, (r,), dev)
    order = torch.sort(torch.where(pool.alive, u, 2.0), stable=True).indices
    rank = torch.empty((r,), dtype=torch.int64, device=dev)
    rank[order] = torch.arange(r, device=dev)
    keep = pool.alive & (rank < n_keep)
    throughput = pool.throughput / p_keep
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    perm = torch.zeros((cap,), dtype=torch.int64, device=dev)
    perm[pos[keep]] = torch.arange(r, device=dev)[keep]
    row_alive = torch.arange(cap, device=dev) < n_keep

    def take(x):
        out = x[perm]
        mask = row_alive.reshape((cap,) + (1,) * (x.dim() - 1))
        return torch.where(mask, out, torch.zeros((), dtype=x.dtype,
                                                   device=dev))

    new_pool = RayPool(
        origin=take(pool.origin), direction=take(pool.direction),
        throughput=take(throughput),
        radiance=torch.zeros((cap, 3), dtype=torch.float32, device=dev),
        pixel=take(pool.pixel), alive=row_alive, inside=take(pool.inside))
    return new_pool, take(prev_scatter), take(prev_pdf)


def trace_compacted(scene, lights, pool: RayPool, key: rng.Key,
                    opts: RenderOptions, num_pixels: int,
                    with_stats: bool = False):
    """The bounce loop with stream compaction between bounces → the
    (num_pixels, 3) radiance sums: each bounce's radiance is added into the
    image by pixel id, so the shrinking pool loses nothing."""
    if opts.compact is None:
        raise ValueError("trace_compacted needs opts.compact")
    r0 = pool.count
    dev = pool.origin.device
    schedule = opts.compact
    use_nee = opts.nee and lights.count > 0
    image = torch.zeros((num_pixels, 3), dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.float64, device=dev)
    prev_scatter = torch.zeros((r0,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((r0,), dtype=torch.float32, device=dev)

    # the cluster kernel's overflow flag is read once, after the loop
    with _build.overflow_checked_once():
        for depth in range(opts.max_depth):
            kn_, ks_, kc_ = _bounce_keys(key, depth)
            hit = traverse.intersect_scene(
                scene, pool.origin, pool.direction, active=pool.alive,
                method=opts.method)
            segments = segments + pool.alive.sum()
            e_scale = (_emission_scale(hit, pool, lights, prev_scatter,
                                       prev_pdf, opts) if use_nee else None)
            wo = -pool.direction
            res = shade_mod.shade(
                scene.materials, scene.geom.mat_id, pool, hit, ks_, depth,
                opts.max_depth, rr_enabled=opts.russian_roulette,
                rr_start_depth=opts.rr_start_depth, emission_scale=e_scale,
                eps=scene.eps)
            new_pool = res.pool
            delta = new_pool.radiance - pool.radiance
            if use_nee:
                delta = delta + pool.throughput * _nee_contribution(
                    scene, lights, res, hit.point, wo, kn_, opts)
                segments = segments + res.scatter.sum()
            image.index_add_(0, new_pool.pixel.long(), delta)
            prev_scatter, prev_pdf = res.scatter, res.bsdf_pdf
            pool = new_pool._replace(
                radiance=torch.zeros_like(new_pool.radiance))
            if depth + 1 < opts.max_depth:
                frac = schedule[min(depth, len(schedule) - 1)]
                cap = min(pool.count, max(1024, _round_up(int(frac * r0))))
                if cap < pool.count:
                    pool, prev_scatter, prev_pdf = _compact_pool(
                        pool, prev_scatter, prev_pdf, kc_, cap)
    return (image, segments) if with_stats else image


def _schedule_from(fracs, margin: float) -> tuple:
    """Live shares → caps: share × margin, at least 1/64, rounded up to
    1/64, never rising."""
    sched = []
    prev = 1.0
    for f in fracs:
        capped = min(prev, max(f * margin, 1.0 / 64.0))
        capped = min(1.0, (int(capped * 64) + 1) / 64.0)
        capped = min(prev, capped)
        sched.append(capped)
        prev = capped
    return tuple(sched)


def measure_schedule(scene, lights, cam, opts: RenderOptions,
                     width: int = 128, height: int = 128, seed: int = 0,
                     margin: float = 1.35) -> tuple:
    """``mcpt``'s pilot: a wavefront render at ``width``×``height``, one
    sample, without NEE, measuring the live share of the pool after each
    bounce but the last → a compaction schedule for ``opts.compact``."""
    key = rng.key(seed)
    pool = camera_mod.generate_rays(cam, width, height, key=key,
                                    jitter=opts.jitter)
    r = pool.count
    fracs = []
    for depth in range(opts.max_depth - 1):
        hit = traverse.intersect_scene(scene, pool.origin, pool.direction,
                                       active=pool.alive, method=opts.method)
        res = shade_mod.shade(
            scene.materials, scene.geom.mat_id, pool, hit,
            rng.fold_in(key, depth), depth, opts.max_depth,
            rr_enabled=opts.russian_roulette,
            rr_start_depth=opts.rr_start_depth, eps=scene.eps)
        pool = res.pool
        fracs.append(float(pool.alive.sum()) / r)
    return _schedule_from(fracs, margin)


def measure_hybrid_schedule(cms, cam, opts: RenderOptions) -> tuple:
    """The hybrid engine's pilot: per-depth live shares → a compaction
    schedule for ``render_hybrid(compact=...)``.

    It runs the port's own hybrid at 128×128, 1 spp, seed 0, without
    compaction or NEE (NEE adds radiance and never decides a path's life),
    and turns the live shares after each bounce but the last into caps by
    ``mcpt``'s rule.  ``mcpt``'s hybrid takes its caps from its wavefront
    pilot (``measure_schedule``); these differ from those and stay
    unbiased: a cap only decides how many paths the Bernoulli roulette
    keeps."""
    from mcpt_torch.kernels import cluster_megakernel as cmk

    fracs = []
    cmk._run_hybrid(cms, cam, 128, 128, 1, 0, max_depth=opts.max_depth,
                    rr=opts.russian_roulette, rr_start=opts.rr_start_depth,
                    key_mode="cell", live=fracs)
    return _schedule_from(fracs, 1.35)


def render_batch(scene, lights, cam, width: int, height: int, key: rng.Key,
                 opts: RenderOptions, spp: int = 1, with_stats: bool = False):
    """``spp`` samples per pixel in one flat pool → (W·H, 3) radiance sum in
    pixel order, and with ``with_stats`` the float64 segment count.

    ``mcpt``'s key schedule: ``keys = split(key, spp)``; with one sample
    and no compaction, ``keys[0]`` splits into the camera key and the path
    key; otherwise sample i's camera key is ``split(keys[i])[0]`` and the
    paths draw from ``key`` itself.  On the ``cluster`` method the pixels go
    in square tiles of ``BLKT`` (``camera.tile_order``) and the radiance is
    un-permuted at the end."""
    keys = rng.split(key, spp)
    n = width * height
    dev = cam.position.device
    tiled = traverse.resolve_method(scene, opts.method) == "cluster"
    if tiled:
        perm, inv_perm = camera_mod.tile_order(width, height, block=BLKT)
        pix = torch.from_numpy(perm).to(dev)
        inv = torch.from_numpy(inv_perm).to(dev).long()

    def gen(k):
        if tiled:
            return camera_mod.generate_rays_for_pixels(
                cam, width, height, pix, key=k, jitter=opts.jitter)
        return camera_mod.generate_rays(cam, width, height, key=k,
                                        jitter=opts.jitter)

    def untile(radiance_sum):
        return radiance_sum[inv] if tiled else radiance_sum

    if spp == 1 and opts.compact is None:
        k_cam, k_path = rng.split(keys[0])
        out = trace(scene, lights, gen(k_cam), k_path, opts, with_stats=True)
        radiance = untile(out[0].radiance)
        return (radiance, out[1]) if with_stats else radiance

    pools = [gen(rng.split(k)[0]) for k in keys]
    flat = RayPool(*(torch.cat(xs) for xs in zip(*pools)))
    del pools
    if opts.compact is not None:
        # the compacted trace adds into the image by true pixel id
        return trace_compacted(scene, lights, flat, key, opts, num_pixels=n,
                               with_stats=with_stats)
    out, segments = trace(scene, lights, flat, key, opts, with_stats=True)
    per_sample = out.radiance.reshape(spp, n, 3)
    radiance = per_sample[0]
    for s in range(1, spp):
        radiance = radiance + per_sample[s]
    radiance = untile(radiance)
    return (radiance, segments) if with_stats else radiance


def render_sample(scene, lights, cam, width: int, height: int, key: rng.Key,
                  opts: RenderOptions) -> torch.Tensor:
    """One sample per pixel → (W·H, 3) radiance."""
    return render_batch(scene, lights, cam, width, height, key, opts, spp=1)


def render(scene, lights, cam, width: int, height: int, opts: RenderOptions,
           spp: int, seed: int = 0, fb: Framebuffer | None = None,
           progress=None, spp_per_step: int = 1) -> Framebuffer:
    """Progressive accumulation of ``spp`` samples, ``spp_per_step`` per
    ``render_batch``, step s keyed ``fold_in(key(seed), s)``; ``fb``
    resumes an earlier render."""
    from mcpt_torch.types import make_framebuffer

    if fb is None:
        fb = make_framebuffer(width * height, cam.position.device)
    base = rng.key(seed)
    start = int(fb.count.max()) if fb.count.numel() else 0
    s = start
    while s < start + spp:
        step = min(spp_per_step, start + spp - s)
        radiance = render_batch(scene, lights, cam, width, height,
                                rng.fold_in(base, s), opts, spp=step)
        fb = accumulate(fb, radiance, spp=step)
        s += step
        if progress is not None:
            progress(s, fb)
    return fb

