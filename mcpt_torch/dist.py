"""Sharded rendering over ``torch.distributed`` (port of ``mcpt/dist.py``).

A mesh has two named axes over the ranks of the default process group:

- ``samples``: data parallel over the sample axis.  Shard ``si`` renders
  the global samples ``[si·spp/S, (si+1)·spp/S)`` of its pixels, and the
  radiance sums are added over the axis (``all_reduce`` on its group,
  ``mcpt``'s ``psum``);
- ``pixels``: each shard owns one contiguous slice of the pixels (of the
  tile order for the cluster engines) and renders only that slice; the
  slices are gathered over the axis (``all_gather``), so every rank of the
  mesh returns the full (W·H, 3) sum in pixel order, as ``mcpt``'s
  ``out[:n]`` / ``out[inv]`` is.

The segment count is added over the whole mesh.  Rank ``si·P + pi`` holds
mesh coordinates ``(si, pi)``, as ``mcpt``'s ``devices.reshape(S, P)``.
Every rank builds the same scene itself (the builds are deterministic), so
there is no counterpart of ``mcpt``'s ``replicate``.

Determinism.  The kernel engines (``render_mega_sharded``,
``render_cluster_sharded``, ``render_hybrid_sharded`` without compaction)
give every shard the same seed and a ``sample_base`` equal to its first
global sample, so every (sample, pixel) draws its one-device stream: the
sum equals one device's up to the order of the f32 additions, and the
segment count exactly, for any mesh shape.  A slice's padding (the last
slice when P does not divide the pixel count) is not rendered: the shard
renders its true pixels and pads its rows with zeros before the gather
(``mcpt`` renders duplicates of the edge pixel there, under static
shapes).  The wavefront (``render_batch_sharded``) keys each shard with
``fold_in(fold_in(key, si), pi)`` and renders the padded slice with the
edge pixel repeated, as ``mcpt`` does, so it draws ``mcpt``'s sharded
wavefront's numbers: a different but unbiased estimate from one device's.

Backends.  ``nccl`` needs a card per rank; ranks that share a card (and
CPU ranks) use ``gloo`` (``backend_for``).  Gloo's collectives run on host
tensors, so a CUDA tensor is copied to the host for the collective and
back: the renders themselves stay on the card.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from mcpt_torch import rng
from mcpt_torch.render import camera as camera_mod
from mcpt_torch.render import integrator as integ
from mcpt_torch.trace import span
from mcpt_torch.types import Framebuffer, RayPool, make_framebuffer


def backend_for(device, local_world_size: int) -> str:
    """``nccl`` when the ranks run on CUDA and each rank of this host has a
    card of its own, else ``gloo`` (NCCL refuses two ranks on one card)."""
    device = torch.device(device)
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_world(device="cuda") -> tuple[str, torch.device]:
    """Join the default process group from the environment ``torchrun``
    sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) → (backend, this rank's device).

    On CUDA, local rank r takes card r with ``nccl`` and card
    r mod (cards) with ``gloo``; without a card a CUDA request raises."""
    device = torch.device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1")))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a sharded CUDA render needs a CUDA device")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend_for(device, local_world)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return backend, device


class Mesh:
    """A ``(samples, pixels)`` grid over ranks of the default group, with a
    process group per axis line and one over the whole mesh.  Built by
    ``make_mesh`` on every rank of the default group.  On a rank outside the
    mesh ``si`` and ``pi`` are None."""

    def __init__(self, samples: int, pixels: int, ranks: list[int]):
        self.ranks = list(ranks)
        self.shape = {"samples": samples, "pixels": pixels}
        grid = np.asarray(self.ranks).reshape(samples, pixels)
        me = dist.get_rank()
        self.si = self.pi = None
        self.backend = dist.get_backend()
        self.samples_group = self.pixels_group = None
        # new_group is collective over the default group: every rank makes
        # every group, in the same order
        for pi in range(pixels):
            g = dist.new_group(grid[:, pi].tolist())
            if me in grid[:, pi]:
                self.samples_group = g
        for si in range(samples):
            g = dist.new_group(grid[si].tolist())
            if me in grid[si]:
                self.pixels_group = g
        self.group = dist.new_group(self.ranks)
        if me in self.ranks:
            self.si, self.pi = (int(x) for x in
                                np.argwhere(grid == me)[0])

    def _check(self):
        if self.si is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                             f"over ranks {self.ranks}")

    def _all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        """Sum of ``t`` over ``group``, on ``t``'s device."""
        if dist.get_world_size(group) == 1:
            return t
        host = self.backend == "gloo" and t.device.type != "cpu"
        buf = t.cpu() if host else t.clone()
        dist.all_reduce(buf, group=group)
        return buf.to(t.device) if host else buf

    def _all_gather(self, t: torch.Tensor, group) -> torch.Tensor:
        """The ``t`` of every rank of ``group``, concatenated in rank
        order, on ``t``'s device."""
        n = dist.get_world_size(group)
        if n == 1:
            return t
        host = self.backend == "gloo" and t.device.type != "cpu"
        src = t.cpu() if host else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts).to(t.device)

    def combine(self, rows: torch.Tensor, segs: torch.Tensor):
        """This shard's (local_n, 3) rows and segment count → (every shard's
        rows summed over ``samples`` and concatenated over ``pixels``,
        (P·local_n, 3); the segments summed over the mesh)."""
        rows = self._all_reduce(rows, self.samples_group)
        total = self._all_reduce(segs.to(torch.float64).reshape(()),
                                 self.group)
        return self._all_gather(rows, self.pixels_group), total


def make_mesh(samples: int = 1, pixels: int | None = None,
              ranks=None) -> Mesh:
    """Build a ("samples", "pixels") mesh over ``ranks`` (default: every
    rank of the default group; ``mcpt``'s ``devices``).  Every rank of the
    default group must call it with the same arguments."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's default "
                           "process group (init_world)")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    if pixels is None:
        if n % samples:
            raise ValueError(f"{n} ranks do not split into samples={samples}")
        pixels = n // samples
    if samples * pixels != n:
        raise ValueError(f"samples {samples} × pixels {pixels} != {n} ranks")
    return Mesh(samples, pixels, ranks)


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _split(mesh: Mesh, spp: int, n: int):
    """(spp a shard, pixels a slice, this shard's first slice position,
    its true pixel count)."""
    mesh._check()
    d_s, d_p = mesh.shape["samples"], mesh.shape["pixels"]
    if spp % d_s:
        raise ValueError(f"spp {spp} not divisible by samples axis {d_s}")
    local_n = _pad_to(n, d_p) // d_p
    base = mesh.pi * local_n
    return spp // d_s, local_n, base, max(0, min(local_n, n - base))


def render_batch_sharded(scene, lights, cam, width: int, height: int,
                         key: rng.Key, opts: integ.RenderOptions, spp: int,
                         mesh: Mesh, with_stats: bool = False):
    """One sharded wavefront step → (W·H, 3) radiance sum over ``spp``
    samples in pixel order (and with ``with_stats`` the mesh's total
    live-segment count, float64).

    ``mcpt``'s schedule: the shard key is ``fold_in(fold_in(key, si),
    pi)``; its slice is padded to W·H / P rounded up with the last pixel
    repeated; sample i's camera key is ``split(split(k, spp/S)[i])[0]`` and
    the paths draw from the shard key."""
    n = width * height
    spp_local, local_n, base, _ = _split(mesh, spp, n)
    dev = cam.position.device
    k_dev = rng.fold_in(rng.fold_in(key, mesh.si), mesh.pi)
    pix = torch.clamp(base + torch.arange(local_n, dtype=torch.int32,
                                          device=dev), max=n - 1)
    pools = [camera_mod.generate_rays_for_pixels(
        cam, width, height, pix, key=rng.split(k)[0], jitter=opts.jitter)
        for k in rng.split(k_dev, spp_local)]
    flat = RayPool(*(torch.cat(xs) for xs in zip(*pools)))
    del pools
    flat, segs = integ.trace(scene, lights, flat, k_dev, opts,
                             with_stats=True)
    local = flat.radiance.reshape(spp_local, local_n, 3).sum(dim=0)
    rows, segs = mesh.combine(local, segs)
    return (rows[:n], segs) if with_stats else rows[:n]


def render_sharded(scene, lights, cam, width: int, height: int,
                   opts: integ.RenderOptions, spp: int, mesh: Mesh,
                   seed: int = 0, fb: Framebuffer | None = None,
                   spp_per_step: int | None = None,
                   progress=None) -> Framebuffer:
    """Progressive sharded accumulation (``integrator.render`` over the
    mesh).  The request rounds up once to a multiple of the samples axis,
    so ``fb.count`` equals the samples rendered."""
    d_s = mesh.shape["samples"]
    if spp_per_step is None:
        spp_per_step = d_s
    if spp_per_step % d_s:
        raise ValueError(f"spp_per_step {spp_per_step} not divisible by "
                         f"samples axis {d_s}")
    spp = _pad_to(spp, d_s)
    if fb is None:
        fb = make_framebuffer(width * height, cam.position.device)
    base = rng.key(seed)
    start = int(fb.count.max()) if fb.count.numel() else 0
    s = start
    while s < start + spp:
        step = min(spp_per_step, start + spp - s)
        step = (step // d_s) * d_s
        radiance = render_batch_sharded(scene, lights, cam, width, height,
                                        rng.fold_in(base, s), opts, step,
                                        mesh)
        fb = integ.accumulate(fb, radiance, spp=step)
        s += step
        if progress is not None:
            progress(s, fb)
    return fb


def render_mega_sharded(mega, cam, width: int, height: int, spp: int,
                        mesh: Mesh, seed: int = 0, max_depth: int = 16,
                        nee: bool = False, mis: bool = False,
                        rr: bool = False, clamp: float = 0.0,
                        rr_start: int = 3):
    """Sharded dense megakernel (kernel 1) → ((W·H, 3) radiance sum over
    ``spp``, the mesh's segment count).  Each shard renders its pixel slice
    through the kernel's ``pixel_base`` / ``pixel_count`` and its samples
    through ``sample_base``, with the same seed.  The last slice renders
    its true count (the kernel refuses pixels past W·H) and its rows are
    padded here."""
    from mcpt_torch.kernels import megakernel as mk

    n = width * height
    spp_local, local_n, base, count = _split(mesh, spp, n)
    dev = mega.tri.device
    rows = torch.zeros((local_n, 3), dtype=torch.float32, device=dev)
    segs = torch.zeros((), dtype=torch.float64, device=dev)
    if count:
        rad, segs = mk.render_mega(
            mega, cam, width, height, spp=spp_local, seed=seed,
            max_depth=max_depth, rr=rr, rr_start=rr_start, nee=nee, mis=mis,
            clamp=clamp, pixel_base=base, pixel_count=count,
            sample_base=mesh.si * spp_local)
        rows[:count] = rad
    out, segs = mesh.combine(rows, segs)
    return out[:n], segs


def _tile_slice(mesh: Mesh, width: int, height: int, spp: int, device):
    """The shard's part of the tile order: (spp a shard, slice length, this
    shard's true pixels: its slice of the tile permutation, on ``device``,
    without the edge padding of ``mcpt`` ``dist.py:294-301``)."""
    from mcpt_torch.kernels import cluster_megakernel as cmk

    spp_local, local_n, base, count = _split(mesh, spp, width * height)
    perm = cmk.tile_pixels(width, height, device)[0]
    return spp_local, local_n, perm[base:base + count]


@functools.lru_cache(maxsize=4)
def _shard_rows(width: int, height: int, pixels: int, device: torch.device):
    """The gathered rows of the sharded hybrid in pixel order, computed on
    ``device`` once per (width, height, ``pixels`` extent, device) → int64
    ``inv`` with ``out[inv]`` the (W·H, 3) image.  Slice i of the tile
    permutation leaves its true pixels in ascending order at rows
    ``i·local_n + j``; its padding rows (a short or empty last slice) are
    never picked.  Nobody writes to it, as with ``tile_pixels``."""
    from mcpt_torch.kernels import cluster_megakernel as cmk

    with span("mcpt.dist.shard_rows"):
        n = width * height
        local_n = _pad_to(n, pixels) // pixels
        perm = cmk.tile_pixels(width, height, device)[0]
        inv = torch.empty(n, dtype=torch.int64, device=device)
        for lo in range(0, n, local_n):
            hi = min(lo + local_n, n)
            inv[torch.sort(perm[lo:hi]).values] = torch.arange(
                lo, hi, dtype=torch.int64, device=device)
        return inv


def _pad_rows(rad: torch.Tensor, local_n: int) -> torch.Tensor:
    rows = torch.zeros((local_n, 3), dtype=torch.float32, device=rad.device)
    rows[:rad.shape[0]] = rad
    return rows


def render_cluster_sharded(cms, cam, width: int, height: int, spp: int,
                           mesh: Mesh, seed: int = 0, max_depth: int = 8,
                           nee: bool = False, mis: bool = False,
                           rr: bool = False, rr_start: int = 3,
                           clamp: float = 0.0):
    """Sharded cluster megakernel (kernel 3) → ((W·H, 3) radiance sum, the
    mesh's segment count).  The tile permutation is sliced over ``pixels``
    (each shard keeps whole square tiles, so its warps stay coherent), the
    samples go through ``sample_base``, and each shard renders in the batch
    schedule, as ``mcpt``'s sharded cluster engine does."""
    from mcpt_torch.kernels import cluster_megakernel as cmk

    dev = cms.wnodes.device
    spp_local, local_n, mine = _tile_slice(mesh, width, height, spp, dev)
    segs = torch.zeros((), dtype=torch.float64, device=dev)
    rad = torch.zeros((0, 3), dtype=torch.float32, device=dev)
    if mine.numel():
        rad, segs = cmk.render_cluster_mega(
            cms, cam, width, height, spp_local, seed, max_depth=max_depth,
            rr=rr, rr_start=rr_start, nee=nee, mis=mis, clamp=clamp,
            schedule="batch", pix=mine, sample_base=mesh.si * spp_local)
    with span("mcpt.dist.combine"):
        out, segs = mesh.combine(_pad_rows(rad, local_n), segs)
        # rows follow the tile order; rows past W·H are the padding
        _, inv, _ = cmk.tile_pixels(width, height, dev)
        return out[inv], segs


def render_hybrid_sharded(cms, cam, width: int, height: int, spp: int,
                          mesh: Mesh, seed: int = 0, max_depth: int = 8,
                          nee: bool = False, mis: bool = False,
                          rr: bool = False, rr_start: int = 3,
                          clamp: float = 0.0, compact: tuple | None = None,
                          key_mode: str = "auto"):
    """Sharded hybrid fused-bounce engine (kernel 2) → ((W·H, 3) radiance
    sum, the mesh's segment count).  Each shard runs the whole pipeline
    (fused bounces, coherence re-sort, compaction to ``compact``'s caps) on
    its slice of the tile permutation and its samples, and its final reduce
    leaves its rows in ascending pixel id order (``mcpt`` ``dist.py:383-
    396``).  Without ``compact`` the result is stream-exact against one
    device; with it each shard compacts its own pool, which stays unbiased
    but draws other roulette numbers."""
    from mcpt_torch.kernels import cluster_megakernel as cmk

    dev = cms.wnodes.device
    spp_local, local_n, mine = _tile_slice(mesh, width, height, spp, dev)
    segs = torch.zeros((), dtype=torch.float64, device=dev)
    rad = torch.zeros((0, 3), dtype=torch.float32, device=dev)
    if mine.numel():
        rad, segs = cmk.render_hybrid(
            cms, cam, width, height, spp_local, seed, max_depth=max_depth,
            rr=rr, rr_start=rr_start, nee=nee, mis=mis, clamp=clamp,
            compact=compact, key_mode=key_mode, perm=mine,
            sample_base=mesh.si * spp_local)
    with span("mcpt.dist.combine"):
        out, segs = mesh.combine(_pad_rows(rad, local_n), segs)
        inv = _shard_rows(width, height, mesh.shape["pixels"], dev)
        return out[inv], segs
