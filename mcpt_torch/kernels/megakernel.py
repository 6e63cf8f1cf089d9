"""The dense megakernel: whole path lifetimes for small scenes, one lane each.

Port of ``mcpt/pallas/megakernel.py`` (``_render_mega_jit``, whose
``pallas_call`` is at line 1168).  Three layers:

- host tables — ``pack_materials``, ``pack_lights``, ``MegaScene`` and
  ``build_megascene`` — numpy with ``mcpt``'s row contracts (tri rows
  ``A|b|normal|mat``, material rows ``kd|ks|ka|ns|ni|mtype``, light rows
  ``v0|e1|e2|emission|normal|cdf``), the Morton row sort past
  ``UNROLL_MAX_TRIS`` tris, never-hit pad rows and 16-row chunk AABBs;
- ``render_mega_reference`` — the plain PyTorch version: the same counter-hash
  RNG, camera ray, closest hit, bounce core and both lane schedules, written
  as tensor ops over lanes (``render_lanes_reference``, which the cluster
  megakernel's plain version runs with its own intersectors and pixel
  table);
- ``render_mega`` — the dispatcher (``_build.use_kernel``): the plain
  version for CPU tensors, the hand-written CUDA kernel
  (``mcpt_torch/csrc/megakernel.cu``) for CUDA tensors, and an exception
  for anything else.  Nothing falls back.

Both versions let a lane stop at its own death.  The TPU kernel keeps dead
lanes iterating until the whole block retires; that is the same estimator
because a dead lane's update adds ``min(0 · finite, clamp) = 0`` to its
radiance and nothing to its segment count (throughput stays finite: it is a
product of BSDF weights and RR factors ≤ 1/0.05).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mcpt_torch import types as T
from mcpt_torch.kernels import _build
from mcpt_torch.trace import span

# Scenes up to this size keep their triangle rows in scene order (the TPU
# kernel fully unrolls them); past it, rows are Morton-sorted into
# CHUNK_TRIS-row chunks with a box each, which the chunk cull tests first.
UNROLL_MAX_TRIS = 128
CHUNK_TRIS = 16
# plain version: triangle rows tested per (lanes × rows) tensor pass
_ROWS_PER_PASS = 64

_MISS = 3.0e38
_M32 = 0xFFFFFFFF
# murmur3 fmix32 constants and the golden-ratio salt stride (uint32)
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GR = 0x9E3779B1

# kernel launches (``_build.LAUNCHES["mcpt_render_mega"]``) by the table
# home ``table_home`` chose for them
HOMES = {"shared": 0, "global": 0}
# the shared memory a block may hold, less the 19-float sf table: tables
# past it stay in global memory
SMEM_TABLE_BYTES = 232448 - 19 * 4
_HOME_CODES = {"shared": 0, "global": 1}
# work the kernel does that ``render_mega_reference`` counts as it runs:
# triangle rows Wald-tested and chunk boxes slab-tested (exact in the
# unrolled tier; in the chunked tier a lower bound: every box, plus one
# chunk's rows per closest hit and one row per blocked shadow ray) — the
# counts behind chip_smoke.py's bound
WORK = {"boxes": 0, "rows": 0}


# --------------------------------------------------------------------------
# counter-hash RNG — uint32 arithmetic held in int64 tensors
# --------------------------------------------------------------------------


def _u32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2³² for a in [0, 2³²): split c in 16-bit halves so no
    partial product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values; ``>>`` is logical because the
    int64 holder is never negative (``mcpt`` uses shift_right_logical on
    int32, ``megakernel.py:80-87``)."""
    h = _u32(h, None)
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def _u01(seed, salt, idx: torch.Tensor) -> torch.Tensor:
    """Uniform in [0, 1) from the hash of (seed, salt, lane counter) —
    bit-equal to ``mcpt.pallas.megakernel._u01`` (the int32 wraparound of
    ``seed + salt·GR`` and ``idx·GR`` is reproduced mod 2³²)."""
    dev = idx.device
    h = _fmix32((_u32(seed, dev) + _mul32(_u32(salt, dev), _GR)) & _M32)
    h = _fmix32(_mul32(_u32(idx, dev), _GR) ^ h)
    return (h & 0x7FFFFF).to(torch.float32) * (1.0 / 8388608.0)


def _pow(x, n):
    """x**n as exp(n·log(max(x, 1e-12))) — the TPU kernel's form, kept so the
    two agree to rounding."""
    return torch.exp(n * torch.log(torch.clamp(x, min=1e-12)))


def _normalize3(x, y, z):
    """Unit vector; ``1/sqrt`` (two IEEE-rounded ops, the same on CPU, in
    PyTorch's CUDA kernels and in the hand-written kernel) where ``mcpt``
    writes rsqrt, whose approximations differ by an ulp across backends."""
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z + 1e-20)
    return x * inv, y * inv, z * inv


def _onb(nx, ny, nz):
    """Branchless orthonormal basis (Duff et al.)."""
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    return ((1.0 + s * nx * nx * a, s * b, -s * nx),
            (b, s + ny * ny * a, -ny))


# --------------------------------------------------------------------------
# host tables
# --------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _expand_bits_np(x: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd position (Karras Morton expansion)."""
    x = (x | (x << 16)) & np.uint32(0x030000FF)
    x = (x | (x << 8)) & np.uint32(0x0300F00F)
    x = (x | (x << 4)) & np.uint32(0x030C30C3)
    x = (x | (x << 2)) & np.uint32(0x09249249)
    return x


def pack_materials(mats: T.Materials) -> np.ndarray:
    """(M, 16) f32 material rows: 0:3 kd, 3:6 ks, 6:9 ka, 9 ns, 10 ni,
    11 mtype."""
    count = mats.count
    matt = np.zeros((max(count, 1), 16), np.float32)
    matt[:count, 0:3] = _np(mats.kd)
    matt[:count, 3:6] = _np(mats.ks)
    matt[:count, 6:9] = _np(mats.ka)
    matt[:count, 9] = _np(mats.ns)
    matt[:count, 10] = _np(mats.ni)
    matt[:count, 11] = _np(mats.mtype).astype(np.float32)
    return matt


def pack_lights(scene: T.Scene, lights):
    """NEE light table rows (v0, e1, e2, emission, unit normal, area CDF) →
    (lit, n_lights, total_area)."""
    if lights is None or lights.count == 0:
        return np.zeros((1, 16), np.float32), 0, 0.0
    ids = _np(lights.tri).astype(np.int64)
    n_lights = len(ids)
    lv = _np(scene.geom.verts)[ids]
    lit = np.zeros((n_lights, 16), np.float32)
    lit[:, 0:3] = lv[:, 0]
    lit[:, 3:6] = lv[:, 1] - lv[:, 0]
    lit[:, 6:9] = lv[:, 2] - lv[:, 0]
    lit[:, 9:12] = _np(lights.emission)
    lit[:, 12:15] = _np(scene.geom.normals)[ids]
    lit[:, 15] = _np(lights.cdf)
    return lit, n_lights, float(_np(lights.total_area))


class MegaScene(NamedTuple):
    """Kernel tables, built once per scene, on one device."""

    tri: torch.Tensor  # (T_pad, 16) f32 — Morton row order past the unroll cap
    cbox: torch.Tensor  # (T_pad/CHUNK, 8) f32 chunk AABBs ((1, 8) if unrolled)
    matt: torch.Tensor  # (M_pad, 16) f32 — one row per material
    lit: torch.Tensor  # (L, 16) f32 — emissive-tri table (NEE)
    n_tris: int
    n_mats: int
    n_lights: int
    eps: float
    total_light_area: float


def build_megascene(scene: T.Scene, lights=None, device=None) -> MegaScene:
    """Pack Wald transforms, normals and material ids into kernel rows
    (``mcpt.pallas.megakernel.build_megascene``'s tables, bit for bit).
    ``lights`` (``mcpt_torch.scene.Lights``) enables the NEE table; the
    tables go to ``device`` (default: the scene's device)."""
    if scene.wald is None:
        raise ValueError("scene has no Wald transforms")
    if device is None:
        device = scene.geom.verts.device
    w = _np(scene.wald.w)  # (3, T, 3), w[k, t, j] = A[t, j, k]
    b = _np(scene.wald.b)
    t_count = b.shape[0]
    tri = np.zeros((t_count, 16), np.float32)
    tri[:, 0:9] = np.transpose(w, (1, 2, 0)).reshape(t_count, 9)
    tri[:, 9:12] = b
    tri[:, 12:15] = _np(scene.geom.normals)
    tri[:, 15] = np.clip(_np(scene.geom.mat_id), 0, None).astype(np.float32)

    verts3 = _np(scene.geom.verts).astype(np.float32).reshape(t_count, 3, 3)
    if t_count > UNROLL_MAX_TRIS:
        # Morton-sort rows so each chunk is spatially tight for the cull;
        # the light table indexes the original geometry separately
        cen = verts3.mean(axis=1)
        lo = cen.min(axis=0)
        ext = np.maximum(cen.max(axis=0) - lo, 1e-20)
        q = np.clip((cen - lo) / ext * 1024.0, 0.0, 1023.0).astype(np.uint32)
        code = ((_expand_bits_np(q[:, 2]) << 2)
                | (_expand_bits_np(q[:, 1]) << 1)
                | _expand_bits_np(q[:, 0]))
        perm = np.argsort(code, kind="stable")
        tri = tri[perm]
        verts3 = verts3[perm]

    matt = pack_materials(scene.materials)
    m_count = matt.shape[0]
    pad = (-t_count) % CHUNK_TRIS
    if pad:
        tri = np.pad(tri, ((0, pad), (0, 0)))
        matt = np.pad(matt, ((0, pad), (0, 0)))
        # pad rows: A = 0, b2 = 1 ⇒ d'_w = 0 ⇒ t = -inf, never a hit
        tri[t_count:, 11] = 1.0

    if t_count > UNROLL_MAX_TRIS:
        # chunk boxes; pad rows excluded with ±inf (every chunk holds a real
        # row, so no box inverts)
        n_rows = tri.shape[0]
        tmin = np.full((n_rows, 3), np.inf, np.float32)
        tmax = np.full((n_rows, 3), -np.inf, np.float32)
        tmin[:t_count] = verts3.min(axis=1)
        tmax[:t_count] = verts3.max(axis=1)
        nch = n_rows // CHUNK_TRIS
        cbox = np.zeros((nch, 8), np.float32)
        cbox[:, 0:3] = tmin.reshape(nch, CHUNK_TRIS, 3).min(axis=1)
        cbox[:, 3:6] = tmax.reshape(nch, CHUNK_TRIS, 3).max(axis=1)
    else:
        cbox = np.zeros((1, 8), np.float32)  # not read below the cap

    lit, n_lights, total_area = pack_lights(scene, lights)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return MegaScene(
        tri=dev(tri), cbox=dev(cbox), matt=dev(matt), lit=dev(lit),
        n_tris=t_count, n_mats=m_count, n_lights=n_lights,
        eps=float(_np(scene.eps)), total_light_area=total_area,
    )


# --------------------------------------------------------------------------
# launch parameters (the TPU kernel's si/sf scalar tables)
# --------------------------------------------------------------------------


def _si(n_tris, n_mats, n_lights, width, height, spp, seed, max_depth, rr,
        rr_start, n_pixels, pixel_base, sample_base) -> np.ndarray:
    """int32[14]: 0 width, 1 height, 2 n_tris, 3 max_depth, 4 seed, 5 rr,
    6 rr_start, 7 n_pixels, 8 n_mats, 9 n_lights, 10 pixel_base, 11 W·H,
    12 spp, 13 sample_base.  The seed wraps to int32 as ``mcpt``'s does."""
    vals = [width, height, n_tris, max_depth, seed, int(rr), rr_start,
            n_pixels, n_mats, n_lights, pixel_base, width * height,
            spp, sample_base]
    return np.array([int(v) & _M32 for v in vals], np.uint32).view(np.int32)


def _sf(mega: MegaScene, cam: T.Camera, t_min, clamp) -> torch.Tensor:
    """f32[19] on the camera's device: 0:3 position, 3:6 forward, 6:9 right,
    9:12 up, 12 half_w, 13 half_h, 14 eps, 15 t_min, 16 total light area,
    17 is_ortho, 18 clamp (0 disables)."""
    dev = cam.position.device
    tail = torch.tensor([mega.eps, t_min, mega.total_light_area],
                        dtype=torch.float32, device=dev)
    return torch.cat([
        cam.position.reshape(3), cam.forward.reshape(3),
        cam.right.reshape(3), cam.up.reshape(3),
        cam.half_width.reshape(1), cam.half_height.reshape(1), tail,
        cam.is_ortho.reshape(1),
        torch.tensor([clamp], dtype=torch.float32, device=dev),
    ]).to(torch.float32).contiguous()


def table_bytes(n_rows: int, n_mat_rows: int, n_lit_rows: int,
                n_chunks: int) -> int:
    """Shared memory a block of the kernel stages the tables in: 12-float
    triangle rows, 8-float chunk boxes, 16-float material and light rows
    (the counts are the tables' first dimensions)."""
    return 48 * n_rows + 32 * n_chunks + 64 * (n_mat_rows + n_lit_rows)


def table_home(n_rows: int, n_mat_rows: int, n_lit_rows: int,
               n_chunks: int) -> str:
    """Where the kernel reads a launch's tables: ``"shared"`` (a copy in
    each block's shared memory) when they fit it, else ``"global"`` (every
    table read through the cache)."""
    need = table_bytes(n_rows, n_mat_rows, n_lit_rows, n_chunks)
    return "shared" if need <= SMEM_TABLE_BYTES else "global"


def tier(n_tris: int) -> str:
    """The kernel's instantiation for a scene: ``"unrolled"`` (every row
    in order) up to ``UNROLL_MAX_TRIS`` triangles, ``"chunked"`` past it."""
    return "chunked" if n_tris > UNROLL_MAX_TRIS else "unrolled"


def _resolve_schedule(schedule: str, spp: int) -> bool:
    """True for ``regen``: one lane per pixel, in-place path regeneration
    through all spp samples; ``batch``: one lane per (sample, pixel);
    ``auto``: regen when spp > 1."""
    if schedule == "auto":
        schedule = "regen" if spp > 1 else "batch"
    if schedule not in ("regen", "batch"):
        raise ValueError(f"unknown schedule {schedule!r}")
    return schedule == "regen"


# --------------------------------------------------------------------------
# the plain PyTorch version
# --------------------------------------------------------------------------


def _wald(rows, o, d, t_min, t_max):
    """Wald unit-triangle test of (…, k, 16) triangle rows (0:9 A, 9:12 b)
    against rays o, d (three tensors each, broadcasting against the rows)
    → (t, hit in (t_min, t_max) inside the triangle).  The CUDA kernels'
    ``wald`` (``csrc/bounce_core.cuh``) does these operations in this
    order."""
    a = [rows[..., j] for j in range(12)]
    opz = a[6] * o[0] + a[7] * o[1] + a[8] * o[2] + a[11]
    dpz = a[6] * d[0] + a[7] * d[1] + a[8] * d[2]
    th = -opz / dpz
    opx = a[0] * o[0] + a[1] * o[1] + a[2] * o[2] + a[9]
    dpx = a[0] * d[0] + a[1] * d[1] + a[2] * d[2]
    u = opx + th * dpx
    opy = a[3] * o[0] + a[4] * o[1] + a[5] * o[2] + a[10]
    dpy = a[3] * d[0] + a[4] * d[1] + a[5] * d[2]
    v = opy + th * dpy
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (th > t_min)
          & (th < t_max))
    return th, ok


def _closest(tri, ox, oy, oz, dx, dy, dz, t_min):
    """Closest Wald hit over all rows in row order, strict ``<`` (the first
    row wins an exact tie, as in the TPU kernel).  → (best_t, best_i) with
    best_t = 3e38, best_i = 0 on a miss.  Elementwise, never a matmul."""
    n = ox.shape[0]
    best_t = torch.full((n,), _MISS, dtype=torch.float32, device=ox.device)
    best_i = torch.zeros((n,), dtype=torch.int64, device=ox.device)
    o = (ox[:, None], oy[:, None], oz[:, None])
    d = (dx[:, None], dy[:, None], dz[:, None])
    for r0 in range(0, tri.shape[0], _ROWS_PER_PASS):
        c = tri[r0:r0 + _ROWS_PER_PASS]
        k = c.shape[0]
        th, ok = _wald(c[None], o, d, t_min, _MISS)
        th = torch.where(ok, th, math.inf)
        m = th.min(dim=1).values
        cols = torch.arange(k, device=ox.device)
        first = torch.where(th == m[:, None], cols, k).min(dim=1).values
        upd = m < best_t
        best_t = torch.where(upd, m, best_t)
        best_i = torch.where(upd, first + r0, best_i)
    return best_t, best_i


def _occluded_first(tri, sox, soy, soz, iwx, iwy, iwz, limit, t_min):
    """Any Wald hit in (t_min, limit) → (bool per lane, the first blocking
    row per lane, or the row count where none blocks)."""
    n_rows = tri.shape[0]
    occ = torch.zeros(sox.shape, dtype=torch.bool, device=sox.device)
    first = torch.full(sox.shape, n_rows, dtype=torch.int64,
                       device=sox.device)
    o = (sox[:, None], soy[:, None], soz[:, None])
    d = (iwx[:, None], iwy[:, None], iwz[:, None])
    lim = limit[:, None]
    for r0 in range(0, n_rows, _ROWS_PER_PASS):
        _, ok = _wald(tri[r0:r0 + _ROWS_PER_PASS][None], o, d, t_min, lim)
        blocks = ok.any(dim=1)
        first = torch.where(blocks & ~occ,
                            r0 + ok.to(torch.int64).argmax(dim=1), first)
        occ = occ | blocks
    return occ, first


def _occluded(tri, sox, soy, soz, iwx, iwy, iwz, limit, t_min):
    """Any Wald hit in (t_min, limit) → bool per lane."""
    return _occluded_first(tri, sox, soy, soz, iwx, iwy, iwz, limit,
                           t_min)[0]


def _dense_pair(mega: MegaScene):
    """The dense (closest, occluded) intersectors ``_bounce`` takes, over
    every real triangle row in row order; they add the kernel's work to
    ``WORK`` as they go."""
    chunked = mega.n_tris > UNROLL_MAX_TRIS
    n_chunks = mega.cbox.shape[0]

    def closest(ox, oy, oz, dx, dy, dz, t_min):
        best_t, best_i = _closest(mega.tri, ox, oy, oz, dx, dy, dz, t_min)
        n = ox.shape[0]
        if chunked:
            WORK["boxes"] += n * n_chunks
            WORK["rows"] += CHUNK_TRIS * int((best_t < _MISS).sum())
        else:
            WORK["rows"] += n * mega.n_tris
        return best_t, mega.tri[best_i]

    def occluded(sox, soy, soz, iwx, iwy, iwz, limit, t_min):
        occ, first = _occluded_first(mega.tri, sox, soy, soz, iwx, iwy, iwz,
                                     limit, t_min)
        if chunked:
            n_occ = int(occ.sum())
            WORK["boxes"] += (occ.numel() - n_occ) * n_chunks + n_occ
            WORK["rows"] += n_occ
        else:
            WORK["rows"] += int(torch.where(occ, first + 1,
                                            mega.n_tris).sum())
        return occ

    return closest, occluded


class _Ctx(NamedTuple):
    """Per-call constants of the plain version (the sf table as Python
    floats, each an exact float32 value).  ``mega`` is the engine's table
    set: its ``matt``, ``lit`` and ``n_lights`` are read."""

    mega: MegaScene
    cdf: torch.Tensor
    seed: int
    sf: list
    use_nee: bool
    use_mis: bool


def _cam_ray(ctx: _Ctx, pxf, pyf, width, height, idx):
    """Jittered pinhole/ortho camera ray for each lane's pixel, RNG stream
    ``idx`` (``rayGenerator.cl:13-27``)."""
    sf = ctx.sf
    fx = pxf + _u01(ctx.seed, 1, idx)
    fy = pyf + _u01(ctx.seed, 2, idx)
    # divide by a device tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    dims = torch.tensor([float(width), float(height)], dtype=torch.float32,
                        device=pxf.device)
    sx = fx / dims[0] - 0.5
    sy = fy / dims[1] - 0.5
    half_w, half_h, w_ort = sf[12], sf[13], sf[17]
    off = [2.0 * sx * half_w * sf[6 + j] + 2.0 * sy * half_h * sf[9 + j]
           for j in range(3)]
    cdx, cdy, cdz = _normalize3(*[sf[3 + j] + (1.0 - w_ort) * off[j]
                                  for j in range(3)])
    return ([sf[j] + w_ort * off[j] for j in range(3)], [cdx, cdy, cdz])


def _bounce(ctx: _Ctx, st: dict, salt0, pidx, depth_ok, rr_on, closest,
            occluded) -> dict:
    """One path-trace bounce on the live lanes in ``st`` (the TPU kernel's
    ``_make_bounce_core``): intersect → material → emission with the MIS
    discount → BSDF sample → NEE shadow ray → transparent → next ray →
    termination → Russian roulette.

    The intersectors are the engine's: ``closest(ox, oy, oz, dx, dy, dz,
    t_min)`` → (best_t, (n, 16) triangle rows; best_t = 3e38 on a miss) and
    ``occluded(sox, soy, soz, iwx, iwy, iwz, limit, t_min)`` → bool, so the
    dense path and the hybrid share this one estimator, as the CUDA kernels
    share ``bounce_core.cuh``."""
    mega, sf, seed = ctx.mega, ctx.sf, ctx.seed
    eps, t_min, area_l = sf[14], sf[15], sf[16]
    clampv = sf[18] if sf[18] > 0.0 else 3.0e38
    ox, oy, oz, dx, dy, dz = (st[k] for k in ("ox", "oy", "oz", "dx", "dy",
                                               "dz"))
    tr, tg, tb = st["tr"], st["tg"], st["tb"]
    rr, rg, rb = st["rr"], st["rg"], st["rb"]
    alive, inside = st["alive"], st["inside"]
    prev_sc, prev_pdf = st["prev_sc"], st["prev_pdf"]

    best_t, row = closest(ox, oy, oz, dx, dy, dz, t_min)
    nx, ny, nz, mid = row[:, 12], row[:, 13], row[:, 14], row[:, 15]
    hit = (best_t < 3.0e38) & (alive > 0.0)
    segs = st["segs"] + alive

    m = mega.matt[mid.to(torch.int64)]
    kdx, kdy, kdz, ksx, ksy, ksz, kax, kay, kaz, ns_, ni_, mtype = (
        m[:, j] for j in range(12))

    ndotd = nx * dx + ny * dy + nz * dz
    flip = torch.where(ndotd < 0.0, 1.0, -1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    hx = ox + best_t * dx
    hy = oy + best_t * dy
    hz = oz + best_t * dz

    is_lite = hit & (mtype == float(T.LIGHT))
    is_diff = hit & (mtype == float(T.DIFFUSE))
    is_glos = hit & (mtype == float(T.GLOSSY))
    is_tran = hit & (mtype == float(T.TRANSPARENT))

    # LIGHT: gather emission; with NEE it is MIS-discounted after a
    # reflective bounce (or dropped without MIS)
    lmask = is_lite.to(torch.float32)
    if ctx.use_nee:
        pdf_lh = best_t * best_t / torch.clamp(ndotd.abs() * area_l,
                                               min=1e-12)
        if ctx.use_mis:
            rat = pdf_lh / torch.clamp(prev_pdf, min=1e-12)
            w_hit = 1.0 / (1.0 + rat * rat)
        else:
            w_hit = torch.zeros_like(pdf_lh)
        lmask = lmask * (1.0 - prev_sc * (1.0 - w_hit))
    rr = rr + torch.clamp(lmask * tr * kax, max=clampv)
    rg = rg + torch.clamp(lmask * tg * kay, max=clampv)
    rb = rb + torch.clamp(lmask * tb * kaz, max=clampv)

    u1 = _u01(seed, salt0, pidx)
    u2 = _u01(seed, salt0 + 1, pidx)
    u3 = _u01(seed, salt0 + 2, pidx)
    u4 = _u01(seed, salt0 + 3, pidx)

    # diffuse / glossy: cosine or phong-lobe sample
    (t1x, t1y, t1z), (t2x, t2y, t2z) = _onb(nx, ny, nz)
    r_ = torch.sqrt(u1)
    phi = 6.2831853 * u2
    cphi = torch.cos(phi)
    sphi = torch.sin(phi)
    zc = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    wdx = r_ * cphi * t1x + r_ * sphi * t2x + zc * nx
    wdy = r_ * cphi * t1y + r_ * sphi * t2y + zc * ny
    wdz = r_ * cphi * t1z + r_ * sphi * t2z + zc * nz

    mdx = dx - 2.0 * ndotd * flip * nx
    mdy = dy - 2.0 * ndotd * flip * ny
    mdz = dz - 2.0 * ndotd * flip * nz
    (p1x, p1y, p1z), (p2x, p2y, p2z) = _onb(mdx, mdy, mdz)
    cos_a = _pow(torch.clamp(u1, min=1e-12), 1.0 / (ns_ + 1.0))
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    wpx = sin_a * cphi * p1x + sin_a * sphi * p2x + cos_a * mdx
    wpy = sin_a * cphi * p1y + sin_a * sphi * p2y + cos_a * mdy
    wpz = sin_a * cphi * p1z + sin_a * sphi * p2z + cos_a * mdz

    pick_phong = is_glos & (u3 < 0.5)
    sxd = torch.where(pick_phong, wpx, wdx)
    syd = torch.where(pick_phong, wpy, wdy)
    szd = torch.where(pick_phong, wpz, wdz)

    cos_i = sxd * nx + syd * ny + szd * nz
    up_ok = cos_i > 0.0
    cos_ar = torch.clamp(sxd * mdx + syd * mdy + szd * mdz, min=0.0)
    pow_ns = _pow(cos_ar, ns_)
    inv_pi = 1.0 / math.pi
    inv_2pi = 0.15915494
    pdf_d = torch.clamp(cos_i, min=0.0) * inv_pi
    pdf_p = (ns_ + 1.0) * inv_2pi * pow_ns
    pdf_mix = 0.5 * pdf_d + 0.5 * pdf_p
    phong_f = (ns_ + 2.0) * inv_2pi * pow_ns
    scale_g = torch.clamp(cos_i, min=0.0) / torch.clamp(pdf_mix, min=1e-12)
    ok_f = torch.where(up_ok, 1.0, 0.0)
    wrx = torch.where(is_glos, (kdx * inv_pi + ksx * phong_f) * scale_g,
                      kdx) * ok_f
    wry = torch.where(is_glos, (kdy * inv_pi + ksy * phong_f) * scale_g,
                      kdy) * ok_f
    wrz = torch.where(is_glos, (kdz * inv_pi + ksz * phong_f) * scale_g,
                      kdz) * ok_f

    if ctx.use_nee:
        # next-event estimation: pick a light triangle ∝ area (the first CDF
        # bin above ul; the numeric tail ul ≥ last cdf takes the last light)
        ul = _u01(seed, salt0 + 5, pidx)
        ua = _u01(seed, salt0 + 6, pidx)
        ub = _u01(seed, salt0 + 7, pidx)
        li = torch.searchsorted(ctx.cdf, ul, right=True)
        lsel = mega.lit[torch.clamp(li, max=mega.n_lights - 1)]
        L = [lsel[:, j] for j in range(15)]
        su_ = torch.sqrt(ua)
        b1 = su_ * (1.0 - ub)
        b2 = su_ * ub
        tox = L[0] + b1 * L[3] + b2 * L[6] - hx
        toy = L[1] + b1 * L[4] + b2 * L[7] - hy
        toz = L[2] + b1 * L[5] + b2 * L[8] - hz
        dist2 = tox * tox + toy * toy + toz * toz
        dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
        iwx = tox / dist
        iwy = toy / dist
        iwz = toz / dist
        cos_s = iwx * nx + iwy * ny + iwz * nz
        cos_l = (iwx * L[12] + iwy * L[13] + iwz * L[14]).abs()
        pdf_sa = dist2 / torch.clamp(cos_l * area_l, min=1e-12)
        cos_ar2 = torch.clamp(iwx * mdx + iwy * mdy + iwz * mdz, min=0.0)
        pw2 = _pow(cos_ar2, ns_)
        gmask = is_glos.to(torch.float32)
        fx_ = kdx * inv_pi + gmask * ksx * (ns_ + 2.0) * inv_2pi * pw2
        fy_ = kdy * inv_pi + gmask * ksy * (ns_ + 2.0) * inv_2pi * pw2
        fz_ = kdz * inv_pi + gmask * ksz * (ns_ + 2.0) * inv_2pi * pw2
        pdf_d2 = torch.clamp(cos_s, min=0.0) * inv_pi
        pdf_b2 = (1.0 - 0.5 * gmask) * pdf_d2 + 0.5 * gmask * (
            (ns_ + 1.0) * inv_2pi * pw2)
        cand = (is_diff | is_glos) & (cos_s > 0.0) & (cos_l > 1e-6)
        # shadow rays of the candidates only, as the kernels trace them
        # (a non-candidate's occlusion would be masked off anyway)
        ci = torch.nonzero(cand).squeeze(1)
        occ = torch.zeros_like(cand)
        if ci.numel():
            occ[ci] = occluded((hx + eps * iwx)[ci], (hy + eps * iwy)[ci],
                               (hz + eps * iwz)[ci], iwx[ci], iwy[ci],
                               iwz[ci], (dist - 2.0 * eps)[ci], t_min)
        vis = cand.to(torch.float32) * (1.0 - occ.to(torch.float32))
        segs = segs + cand.to(torch.float32)
        if ctx.use_mis:
            rat2 = pdf_b2 / torch.clamp(pdf_sa, min=1e-12)
            w_nee = 1.0 / (1.0 + rat2 * rat2)
        else:
            w_nee = torch.ones_like(pdf_sa)
        gain = vis * (cos_s * w_nee / torch.clamp(pdf_sa, min=1e-12))
        rr = rr + torch.clamp(tr * fx_ * L[9] * gain, max=clampv)
        rg = rg + torch.clamp(tg * fy_ * L[10] * gain, max=clampv)
        rb = rb + torch.clamp(tb * fz_ * L[11] * gain, max=clampv)

    # transparent: Schlick coin between refraction and mirror
    inside_m = inside > 0.0
    eta_i = torch.where(inside_m, ni_, 1.0)
    eta_t = torch.where(inside_m, 1.0, ni_)
    eta = eta_i / eta_t
    n_dot_i = -(nx * dx + ny * dy + nz * dz)
    k_ = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    tir = k_ < 0.0
    sq = torch.sqrt(torch.clamp(k_, min=0.0))
    txd, tyd, tzd = _normalize3((eta * n_dot_i - sq) * nx + eta * dx,
                                (eta * n_dot_i - sq) * ny + eta * dy,
                                (eta * n_dot_i - sq) * nz + eta * dz)
    cos_for_f = torch.where(eta_i <= eta_t, n_dot_i,
                            -(txd * nx + tyd * ny + tzd * nz))
    r0 = (ni_ - 1.0) / (ni_ + 1.0)
    r0 = r0 * r0
    one_m = torch.clamp(1.0 - cos_for_f.abs(), 0.0, 1.0)
    p5 = one_m * one_m
    p5 = p5 * p5 * one_m
    fresnel = r0 + (1.0 - r0) * p5
    do_refr = is_tran & ~tir & ~(u4 < fresnel)
    refrf = do_refr.to(torch.float32)
    w_tran = torch.where(do_refr, eta * eta, 1.0)
    inside = torch.where(is_tran, (1.0 - inside) * refrf
                         + inside * (1.0 - refrf), inside)

    # compose the next ray
    ndx = torch.where(is_tran, torch.where(do_refr, txd, mdx), sxd)
    ndy = torch.where(is_tran, torch.where(do_refr, tyd, mdy), syd)
    ndz = torch.where(is_tran, torch.where(do_refr, tzd, mdz), szd)
    scatterish = is_diff | is_glos | is_tran
    smask = scatterish.to(torch.float32)
    tr = tr * (torch.where(is_tran, w_tran, wrx) * smask + (1.0 - smask))
    tg = tg * (torch.where(is_tran, w_tran, wry) * smask + (1.0 - smask))
    tb = tb * (torch.where(is_tran, w_tran, wrz) * smask + (1.0 - smask))
    ox = torch.where(scatterish, hx + eps * ndx, ox)
    oy = torch.where(scatterish, hy + eps * ndy, oy)
    oz = torch.where(scatterish, hz + eps * ndz, oz)
    dx = torch.where(scatterish, ndx, dx)
    dy = torch.where(scatterish, ndy, dy)
    dz = torch.where(scatterish, ndz, dz)

    dead = ~hit | is_lite | ((is_diff | is_glos) & ~up_ok)
    alive = alive * torch.where(dead, 0.0, 1.0) * depth_ok

    # Russian roulette (rr_on = 0 makes it a no-op: p_srv = 1)
    u5 = _u01(seed, salt0 + 4, pidx)
    p_srv = torch.clamp(torch.maximum(tr, torch.maximum(tg, tb)), 0.05, 1.0)
    p_srv = p_srv * rr_on + (1.0 - rr_on)
    alive = alive * torch.where(u5 < p_srv, 1.0, 0.0)
    inv_p = 1.0 / p_srv
    return dict(
        ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz,
        tr=tr * inv_p, tg=tg * inv_p, tb=tb * inv_p, rr=rr, rg=rg, rb=rb,
        alive=alive, inside=inside, segs=segs,
        prev_sc=(is_diff | is_glos).to(torch.float32),
        prev_pdf=torch.where(is_glos, pdf_mix, pdf_d),
    )


def render_lanes_reference(tables, cam: T.Camera, width: int, height: int,
                           spp: int, seed, max_depth: int, rr: bool,
                           rr_start: int, nee: bool, mis: bool, clamp: float,
                           t_min: float, pix: torch.Tensor, sample_base: int,
                           regen: bool, closest, occluded) -> torch.Tensor:
    """The lanes of a megakernel as tensors → (4, n_lanes) per-lane r, g,
    b and segments.  ``tables`` supplies ``matt``, ``lit``, ``n_lights``,
    ``eps`` and ``total_light_area``; ``(closest, occluded)`` are the
    engine's intersectors (``_bounce``); ``pix`` holds the n_pixels pixel
    ids, and lane l renders pixel ``pix[l % n_pixels]``.

    ``regen`` keeps one lane per pixel and loops while any lane has samples
    left (capped at spp·max_depth iterations, as the TPU kernel is); batch
    keeps one lane per (sample, pixel) and loops while any lane is alive.
    Each iteration gathers the live lanes, runs the bounce core on them and
    scatters them back, so a lane stops at its own death exactly as a CUDA
    thread does.  The RNG counter of a (sample, pixel) is
    ``(sample_base + sample)·W·H + pixel`` mod 2³²."""
    n_pixels = pix.shape[0]
    dev = pix.device
    sf = [float(x) for x in _sf(tables, cam, t_min, clamp).cpu().tolist()]
    use_nee = nee and tables.n_lights > 0
    ctx = _Ctx(mega=tables, cdf=tables.lit[:tables.n_lights, 15].contiguous(),
               seed=int(seed) & _M32, sf=sf, use_nee=use_nee, use_mis=mis)
    total = width * height

    n_lanes = n_pixels if regen else n_pixels * spp
    lane = torch.arange(n_lanes, dtype=torch.int64, device=dev)
    pixel = pix.to(torch.int64)[lane % n_pixels]
    pxf = (pixel % width).to(torch.float32)
    pyf = (pixel // width).to(torch.float32)
    sample = torch.zeros_like(lane) if regen else lane // n_pixels
    ray_idx = ((sample_base + sample) * total + pixel) & _M32
    (ox, oy, oz), (dx, dy, dz) = _cam_ray(ctx, pxf, pyf, width, height,
                                          ray_idx)

    def zeros():
        return torch.zeros(n_lanes, dtype=torch.float32, device=dev)

    st = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz,
              tr=zeros() + 1.0, tg=zeros() + 1.0, tb=zeros() + 1.0,
              rr=zeros(), rg=zeros(), rb=zeros(), alive=zeros() + 1.0,
              inside=zeros(), segs=zeros(), prev_sc=zeros(),
              prev_pdf=zeros())
    depth_v = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    done = torch.zeros(n_lanes, dtype=torch.int64, device=dev)

    it = 0
    while True:
        if regen:
            if it >= spp * max_depth:
                break
            live = torch.nonzero(done < spp).squeeze(1)
        else:
            if it >= max_depth:
                break
            live = torch.nonzero(st["alive"] > 0.0).squeeze(1)
        if live.numel() == 0:
            break
        sub = {k: v[live] for k, v in st.items()}
        if regen:
            dv, dn, pix_l = depth_v[live], done[live], pixel[live]
            salt0 = 8 * dv + 3
            pidx = ((sample_base + dn) * total + pix_l) & _M32
            depth_ok = torch.where(dv + 1 < max_depth, 1.0, 0.0)
            rr_on = torch.where(dv >= rr_start, 1.0, 0.0) * float(bool(rr))
        else:
            salt0 = 8 * it + 3
            pidx = ray_idx[live]
            depth_ok = float(it + 1 < max_depth)
            rr_on = float(bool(rr) and it >= rr_start)
        alive_in = sub["alive"]
        sub = _bounce(ctx, sub, salt0, pidx, depth_ok, rr_on, closest,
                      occluded)
        if regen:
            # path regeneration: a finished path starts its pixel's next
            # sample at once (new camera ray, reset path state)
            died = (alive_in - sub["alive"]) > 0.5
            dn = dn + died.to(torch.int64)
            reg = died & (dn < spp)
            regf = reg.to(torch.float32)
            (cox, coy, coz), cd = _cam_ray(
                ctx, pxf[live], pyf[live], width, height,
                ((sample_base + dn) * total + pix_l) & _M32)
            for k, new in zip(("ox", "oy", "oz"), (cox, coy, coz)):
                sub[k] = torch.where(reg, new, sub[k])
            for k, new in zip(("dx", "dy", "dz"), cd):
                sub[k] = torch.where(reg, new, sub[k])
            for k in ("tr", "tg", "tb"):
                sub[k] = torch.where(reg, 1.0, sub[k])
            for k in ("inside", "prev_sc", "prev_pdf"):
                sub[k] = sub[k] * (1.0 - regf)
            sub["alive"] = sub["alive"] + regf
            depth_v[live] = torch.where(reg, 0, dv + 1)
            done[live] = dn
        for k, v in sub.items():
            st[k][live] = v
        it += 1

    return torch.stack([st["rr"], st["rg"], st["rb"], st["segs"]])


def render_mega_reference(mega: MegaScene, cam: T.Camera, width: int,
                          height: int, spp: int, seed, max_depth: int = 16,
                          rr: bool = False, rr_start: int = 3,
                          nee: bool = False, mis: bool = False,
                          clamp: float = 0.0, t_min: float = 1e-4,
                          pixel_base: int = 0, pixel_count: int | None = None,
                          sample_base: int = 0, schedule: str = "auto"):
    """The plain PyTorch version of the megakernel, on ``mega``'s device →
    ((pixel_count, 3) f32 radiance sum over spp, float64 segment count):
    ``render_lanes_reference`` with the dense intersectors and the linear
    pixel map ``pixel_base + lane % pixel_count``."""
    regen = _resolve_schedule(schedule, spp)
    n_pixels = width * height if pixel_count is None else pixel_count
    pix = pixel_base + torch.arange(n_pixels, dtype=torch.int64,
                                    device=mega.tri.device)
    lanes = render_lanes_reference(
        mega, cam, width, height, spp, seed, max_depth, rr, rr_start, nee,
        mis, clamp, t_min, pix, sample_base, regen, *_dense_pair(mega))
    return _reduce(lanes, regen, spp, n_pixels)


def _reduce(lanes: torch.Tensor, regen: bool, spp: int, n_pixels: int):
    """Per-lane (4, n_lanes) r, g, b, segs → ((n_pixels, 3) radiance sum,
    float64 segment count).  A regen lane already holds its pixel's sample
    sum; batch lanes are summed over samples.  f32 sums of counts past 2²⁴
    are inexact, so the segment counter sums in float64."""
    rad = lanes[:3].t()
    if not regen:
        rad = rad.reshape(spp, n_pixels, 3).sum(dim=0)
    return rad.contiguous(), lanes[3].to(torch.float64).sum()


# --------------------------------------------------------------------------
# the CUDA kernel and the dispatcher
# --------------------------------------------------------------------------


def _render_mega_cuda(mega: MegaScene, cam: T.Camera, width, height, spp,
                      seed, max_depth, rr, rr_start, nee, mis, clamp, t_min,
                      pixel_base, pixel_count, sample_base, schedule,
                      lib=None):
    """Launch ``mcpt_torch/csrc/megakernel.cu`` on the current stream, from
    ``lib`` (default: the library built with ``_build.NVCC_FLAGS``)."""
    with span("mcpt.mega.launch"):
        regen = _resolve_schedule(schedule, spp)
        n_pixels = width * height if pixel_count is None else pixel_count
        for name in ("tri", "cbox", "matt", "lit"):
            _build.check_cuda(f"mega.{name}", getattr(mega, name))
        for name in ("tri", "cbox"):  # read as float4s
            if getattr(mega, name).data_ptr() % 16:
                raise ValueError(f"mega.{name} must be 16-byte aligned")
        sf = _sf(mega, cam, t_min, clamp)
        _build.check_cuda("camera", sf)
        dev = mega.tri.device
        if sf.device != dev:
            raise ValueError(f"camera on {sf.device}, tables on {dev}")
        si = _si(mega.n_tris, mega.n_mats, mega.n_lights, width, height,
                 spp, seed, max_depth, rr, rr_start, n_pixels, pixel_base,
                 sample_base)
        n_lanes = n_pixels if regen else n_pixels * spp
        rows = (mega.tri.shape[0], mega.matt.shape[0], mega.lit.shape[0],
                mega.cbox.shape[0])
        home = table_home(*rows)
        out = torch.empty((4, n_lanes), dtype=torch.float32, device=dev)
        _build.launch(
            "mcpt_render_mega", dev, si.ctypes.data, sf.data_ptr(),
            mega.tri.data_ptr(), mega.matt.data_ptr(), mega.lit.data_ptr(),
            mega.cbox.data_ptr(), *rows,
            int(tier(mega.n_tris) == "chunked"),
            int(nee and mega.n_lights > 0), int(mis), int(regen),
            _HOME_CODES[home], out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), out[3].data_ptr(), lib=lib)
    HOMES[home] += 1
    with span("mcpt.mega.reduce"):
        return _reduce(out, regen, spp, n_pixels)


def render_mega(mega: MegaScene, cam: T.Camera, width: int, height: int,
                spp: int, seed, max_depth: int = 16, rr: bool = False,
                rr_start: int = 3, nee: bool = False, mis: bool = False,
                clamp: float = 0.0, t_min: float = 1e-4, pixel_base: int = 0,
                pixel_count: int | None = None, sample_base: int = 0,
                schedule: str = "auto"):
    """Render spp samples → ((pixel_count, 3) radiance sum, segments), with
    ``mcpt.pallas.megakernel.render_mega``'s arguments (less the TPU-only
    ``interpret`` and the bench instrumentation ``count_rows``).

    The device of ``mega``'s tables decides (``_build.use_kernel``): CPU
    tensors run the plain version, CUDA tensors launch the kernel (or
    raise).  Segments are a float64 0-d tensor on the same device."""
    args = (mega, cam, width, height, spp, seed, max_depth, rr, rr_start,
            nee, mis, clamp, t_min, pixel_base, pixel_count, sample_base,
            schedule)
    if _build.use_kernel("render_mega", mega.tri):
        return _render_mega_cuda(*args)
    return render_mega_reference(*args)
