"""The large-scene engines: the hybrid fused bounce (kernel 2) and the
cluster megakernel (kernel 3).

Port of ``mcpt/pallas/cluster_megakernel.py``'s hybrid pipeline
(``render_hybrid``, ``_render_hybrid_jit`` at :800, ``_fused_bounce_jit``
at :563 with its ``pallas_call`` at :586).  One step renders ``spp`` samples
of every pixel as a flat pool of rays, one lane per (sample, pixel), and runs
``max_depth`` times:

    fused bounce → (Bernoulli roulette to a live cap) → coherence re-sort

- ``ClusterMegaScene`` / ``build_cluster_megascene``: the tables (8-wide top
  tree ``wnodes``, cluster triangle rows ``tri16``, materials, lights) and
  the scene box the sort keys quantise;
- ``walk_reference``: the plain cluster walk, closest hit and any-hit, one
  stack per ray;
- ``fused_bounce_reference``: the plain fused bounce — the walk plugged into
  the dense path's estimator (``megakernel._bounce``);
- ``fused_bounce``: the dispatcher — the plain version for CPU tensors, the
  hand-written CUDA kernel (``mcpt_torch/csrc/fused_bounce.cu``) for CUDA
  tensors, and an exception for anything else.  Nothing falls back;
- ``render_cluster_mega`` (``engine=cluster-mega``; ``_render_cluster_jit``
  at :360 in ``mcpt``, ``pallas_call`` at :418): whole paths per lane, the
  dense megakernel's body with the cluster walk plugged in, pixels in tile
  order.  ``render_cluster_mega_reference`` is its plain version, the
  kernel is ``mcpt_torch/csrc/cluster_mega.cu``;
- the pipeline around it: camera rays, sort keys, the compaction schedule,
  ``render_hybrid`` and the stage-timed ``profile_hybrid``.

The state is one (16, N) float32 tensor, a plane per row (``PLANES``), and
an int32 RNG id per lane (the (sample, pixel) stream, which rides every sort,
so the estimator is the batch schedule's).

Hit ties.  The closest hit keeps the lowest t and, on an exact tie in t, the
lowest ``tri16`` row; a child box is pruned only when its t-near exceeds the
best t.  The answer is then brute force over ``tri16`` in row order,
whatever the visit order.  ``mcpt``'s block walk keeps the first-visited of
two equal t, so the two can differ only on exact ties across clusters.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from mcpt_torch import types as T
from mcpt_torch.bvh.cluster import STACK_CAP, stack_entries
from mcpt_torch.bvh.lbvh import morton30, one_thread
from mcpt_torch.kernels import megakernel as mk

SUBT = 32  # pool rows are a multiple of SUBT (mcpt's ray-block height)
BLKT = SUBT * 128  # pool quantum, and the pixel-tile size of tile_order
COARSE_BITS = 6  # Morton bits of the sort keys' coarse origin cell
PLANES = ("ox", "oy", "oz", "dx", "dy", "dz", "tr", "tg", "tb", "rr", "rg",
          "rb", "alive", "inside", "prev_sc", "prev_pdf")
ALIVE = PLANES.index("alive")
DEAD_KEY = 0x7FFFFFFF  # sort key of a dead ray: dead rays sort last
_MISS = 3.0e38
_M32 = 0xFFFFFFFF
# plain version: lanes bounced per pass (bounds its memory at the full pool)
_LANE_CHUNK = 1 << 18

# kernel launches made by ``fused_bounce`` (kernel 2) and by
# ``render_cluster_mega`` (kernel 3) on CUDA tensors (never the plain
# versions' calls) — read by chip_smoke.py to show the main path used them
LAUNCHES = 0
CLUSTER_MEGA_LAUNCHES = 0
# work done by ``walk_reference``: child boxes slab-tested (8 per internal
# pop) and triangle rows Wald-tested (a leaf's live rows; an any-hit walk
# stops at its first hit, as the CUDA walk does) — the counts behind
# chip_smoke.py's bounds; "all_rows" counts every row of each visited leaf,
# padding included (the count before the walks skipped padding)
WALK_WORK = {"boxes": 0, "rows": 0, "all_rows": 0}


class ClusterMegaScene(NamedTuple):
    """Hybrid-engine tables, built once per scene, on one device."""

    wnodes: torch.Tensor  # (Nw, 64) f32 — 8-wide top tree (ClusterBVH.wnodes)
    tri16: torch.Tensor  # (C·T, 16) f32 — cluster-ordered triangle rows
    matt: torch.Tensor  # (M, 16) f32 — material rows
    lit: torch.Tensor  # (L, 16) f32 — NEE light table
    n_clusters: int
    leaf_size: int
    n_mats: int
    n_lights: int
    eps: float
    total_light_area: float
    # the port's own (ClusterBVH.live, .wide_depth): real rows per cluster,
    # and the wide depth that sizes a walk's stack (stack_entries)
    live: torch.Tensor  # (C,) int32
    wide_depth: int
    # scene AABB, quantised by the inter-bounce sort keys
    bb_lo: tuple = (0.0, 0.0, 0.0)
    bb_inv_ext: tuple = (1.0, 1.0, 1.0)


def build_cluster_megascene(scene: T.Scene, lights=None,
                            device=None) -> ClusterMegaScene:
    """Scene with ``scene.clusters`` → hybrid tables on ``device`` (default:
    the clusters' device)."""
    cl = scene.clusters
    if cl is None:
        raise ValueError(
            "scene has no cluster BVH: build_scene builds one only past 512 "
            f"triangles (this scene has {scene.n_tris}); use engine 'mega'")
    if device is None:
        device = cl.tri16.device
    matt = mk.pack_materials(scene.materials)
    lit, n_lights, total_area = mk.pack_lights(scene, lights)
    v = scene.geom.verts.cpu().numpy().astype(np.float32).reshape(-1, 3)
    lo = v.min(axis=0)
    ext = np.maximum(v.max(axis=0) - lo, np.float32(1e-12))
    return ClusterMegaScene(
        wnodes=cl.wnodes.to(device), tri16=cl.tri16.to(device),
        matt=torch.from_numpy(matt).to(device),
        lit=torch.from_numpy(lit).to(device),
        n_clusters=cl.n_clusters, leaf_size=cl.leaf_size,
        n_mats=matt.shape[0], n_lights=n_lights,
        eps=float(mk._np(scene.eps)), total_light_area=total_area,
        live=cl.live.to(device), wide_depth=cl.wide_depth,
        bb_lo=tuple(float(x) for x in lo),
        bb_inv_ext=tuple(float(x) for x in np.float32(1.0) / ext),
    )


# --------------------------------------------------------------------------
# the plain cluster walk
# --------------------------------------------------------------------------


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| clamped to ≥ 1e-30 (``_make_cluster_intersectors``'
    ``tiny``), so a slab bound is never NaN."""
    tiny = 1e-30
    return 1.0 / torch.where(d.abs() < tiny,
                             torch.where(d < 0.0, -tiny, tiny), d)


def _octant(dx, dy, dz) -> torch.Tensor:
    return ((dx > 0.0).to(torch.int64) + 2 * (dy > 0.0).to(torch.int64)
            + 4 * (dz > 0.0).to(torch.int64))


def walk_reference(wnodes: torch.Tensor, tri16: torch.Tensor, leaf_size: int,
                   ox, oy, oz, dx, dy, dz, t_min: float, limit=None,
                   live=None, stack_cap: int = STACK_CAP):
    """``_walk``: on CPU tensors on one PyTorch thread (its loop is many
    small ops; see ``lbvh.one_thread``)."""
    with one_thread(ox.device):
        return _walk(wnodes, tri16, leaf_size, ox, oy, oz, dx, dy, dz, t_min,
                     limit, live, stack_cap)


def _walk(wnodes: torch.Tensor, tri16: torch.Tensor, leaf_size: int,
          ox, oy, oz, dx, dy, dz, t_min: float, limit=None, live=None,
          stack_cap: int = STACK_CAP):
    """Stack walk of the 8-wide cluster tree, one stack per ray, vectorised
    over rays (each loop pops one node of every ray that has one left).

    Closest hit (``limit`` None) → (best_t, best_row): t = 3e38 and row 0
    on a miss.  Any-hit (``limit`` a tensor) → bool: a hit in
    (t_min, limit).  Children are pushed far-to-near by the ray's own
    direction octant (``wnodes[:, 56 + o]``) and pruned only when their
    t-near exceeds the bound (see the module docstring).  A leaf tests its
    first ``live[cluster]`` rows (all ``leaf_size`` without ``live``): the
    padding rows after them never hit.  A push past ``stack_cap`` entries
    raises: the tables' ``stack_entries(wide_depth)`` rules it out."""
    any_hit = limit is not None
    n = ox.shape[0]
    dev = ox.device
    n_wide = wnodes.shape[0]
    inv = (_safe_inv(dx), _safe_inv(dy), _safe_inv(dz))
    octant = _octant(dx, dy, dz)
    stack = torch.zeros((n, stack_cap), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)  # root 0 pushed
    best_t = torch.full((n,), _MISS, dtype=torch.float32, device=dev)
    best_row = torch.zeros(n, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    shifts = 3 * torch.arange(8, device=dev)
    row_iota = torch.arange(leaf_size, device=dev)
    boxes, all_rows = 0, 0
    rows_tested = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        act = torch.nonzero((sp > 0) & ~occ).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        node = stack[act, sp[act]]
        is_leaf = node >= n_wide

        ia, ni = act[~is_leaf], node[~is_leaf]
        if ia.numel():  # internal: slab-test 8 children, push the hit ones
            boxes += 8 * ia.numel()
            w = wnodes[ni]
            box = w[:, :48].reshape(-1, 8, 6)
            o = (ox[ia, None], oy[ia, None], oz[ia, None])
            t0 = [(box[:, :, j] - o[j]) * inv[j][ia, None] for j in range(3)]
            t1 = [(box[:, :, 3 + j] - o[j]) * inv[j][ia, None]
                  for j in range(3)]
            tn = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                             torch.minimum(t0[1], t1[1])),
                               torch.minimum(t0[2], t1[2]))
            tf = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                             torch.maximum(t0[1], t1[1])),
                               torch.maximum(t0[2], t1[2]))
            bound = (limit[ia] if any_hit else best_t[ia])[:, None]
            hit = (tf >= torch.clamp(tn, min=0.0)) & (tn <= bound)
            code = w.gather(1, 56 + octant[ia, None]).to(torch.int64)
            slot = (code >> shifts) & 7  # (k, 8) child slots, far first
            push = hit.gather(1, slot)
            enc = w[:, 48:56].to(torch.int64).gather(1, slot)
            pos = sp[ia, None] + torch.cumsum(push.to(torch.int64), 1) - 1
            new_sp = sp[ia] + push.sum(1)
            if int(new_sp.max()) > stack_cap:
                raise RuntimeError(
                    f"cluster walk: traversal stack overflow (> {stack_cap}"
                    " entries); collapse_wide should have rejected this tree")
            r, c = torch.nonzero(push, as_tuple=True)
            stack[ia[r], pos[r, c]] = enc[r, c]
            sp[ia] = new_sp

        la, nl = act[is_leaf], node[is_leaf]
        if la.numel():  # leaf: Wald-test the cluster's live rows
            rows = (nl - n_wide)[:, None] * leaf_size + row_iota
            n_live = (torch.full_like(nl, leaf_size) if live is None
                      else live[nl - n_wide].to(torch.int64))
            in_leaf = row_iota < n_live[:, None]
            all_rows += leaf_size * la.numel()
            o = (ox[la, None], oy[la, None], oz[la, None])
            d = (dx[la, None], dy[la, None], dz[la, None])
            if any_hit:
                _, ok = mk._wald(tri16[rows], o, d, t_min, limit[la, None])
                ok &= in_leaf
                blocked = ok.any(dim=1)
                occ[la] |= blocked
                rows_tested += torch.where(
                    blocked, ok.to(torch.int64).argmax(dim=1) + 1,
                    n_live).sum()
            else:
                rows_tested += n_live.sum()
                th, ok = mk._wald(tri16[rows], o, d, t_min, _MISS)
                th = torch.where(ok & in_leaf, th, math.inf)
                m = th.min(dim=1).values
                first = torch.where(th == m[:, None], row_iota,
                                    leaf_size).min(dim=1).values
                row = rows[:, 0] + first
                bt, br = best_t[la], best_row[la]
                upd = (m < bt) | ((m == bt) & (row < br))
                best_t[la] = torch.where(upd, m, bt)
                best_row[la] = torch.where(upd, row, br)
    WALK_WORK["boxes"] += boxes
    WALK_WORK["rows"] += int(rows_tested)
    WALK_WORK["all_rows"] += all_rows
    return occ if any_hit else (best_t, best_row)


def walk_tables(tables, ox, oy, oz, dx, dy, dz, t_min: float, limit=None):
    """``walk_reference`` over a ``ClusterMegaScene`` or a ``ClusterBVH``
    with its live rows and its stack size, as the kernels walk it."""
    return walk_reference(tables.wnodes, tables.tri16, tables.leaf_size, ox,
                          oy, oz, dx, dy, dz, t_min, limit, tables.live,
                          stack_entries(tables.wide_depth))


def _walk_pair(cms: ClusterMegaScene):
    """The (closest, occluded) intersectors ``megakernel._bounce`` takes."""

    def closest(ox, oy, oz, dx, dy, dz, t_min):
        best_t, best_row = walk_tables(cms, ox, oy, oz, dx, dy, dz, t_min)
        return best_t, cms.tri16[best_row]

    def occluded(sox, soy, soz, iwx, iwy, iwz, limit, t_min):
        return walk_tables(cms, sox, soy, soz, iwx, iwy, iwz, t_min, limit)

    return closest, occluded


def _check_walk_tables(tables, dev) -> int:
    """The checks every walking kernel's wrapper makes of its tables
    (``ClusterMegaScene`` or ``ClusterBVH``) → the stack entries a thread
    gets."""
    for name, dtype in (("wnodes", torch.float32), ("tri16", torch.float32),
                        ("live", torch.int32)):
        t = getattr(tables, name)
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"tables on {t.device}, the rest on {dev}")
    if (tables.wnodes.dim() != 2 or tables.wnodes.shape[1] != 64
            or tables.wnodes.shape[0] < 1 or tables.tri16.shape[1:] != (16,)
            or tables.tri16.shape[0] != tables.n_clusters * tables.leaf_size
            or tuple(tables.live.shape) != (tables.n_clusters,)):
        raise ValueError("cluster tables have the wrong shapes")
    if tables.wnodes.data_ptr() % 16 or tables.tri16.data_ptr() % 16:
        raise ValueError("wnodes and tri16 must be 16-byte aligned (the "
                         "kernel reads them as float4)")
    return stack_entries(tables.wide_depth)


# --------------------------------------------------------------------------
# the fused bounce: plain version, CUDA kernel, dispatcher
# --------------------------------------------------------------------------


def _f32(x) -> float:
    return float(np.float32(x))


def fused_bounce_reference(cms: ClusterMegaScene, state: torch.Tensor,
                           rid: torch.Tensor, seed, depth: int,
                           max_depth: int = 8, rr: bool = False,
                           rr_start: int = 3, nee: bool = False,
                           mis: bool = False, clamp: float = 0.0,
                           t_min: float = 1e-4) -> torch.Tensor:
    """One bounce of every live lane of ``state`` (updated in place) →
    (N,) f32 segments traced per lane.

    ``_fused_bounce_jit``'s contract: the closest-hit walk, material resolve,
    emission with the MIS discount, BSDF sample, the NEE any-hit walk and
    Russian roulette, with salts ``8·depth + 3 …`` on the lane's RNG id.  A
    lane with ``alive == 0`` passes through unchanged with 0 segments (the
    TPU kernel passes whole all-dead blocks through)."""
    sf = [0.0] * 19
    sf[14], sf[15] = _f32(cms.eps), _f32(t_min)
    sf[16], sf[18] = _f32(cms.total_light_area), _f32(clamp)
    ctx = mk._Ctx(mega=cms, cdf=cms.lit[:cms.n_lights, 15].contiguous(),
                  seed=int(seed) & _M32, sf=sf,
                  use_nee=bool(nee) and cms.n_lights > 0, use_mis=bool(mis))
    closest, occluded = _walk_pair(cms)
    depth_ok = float(depth + 1 < max_depth)
    rr_on = float(bool(rr) and depth >= rr_start)
    segs = torch.zeros(state.shape[1], dtype=torch.float32,
                       device=state.device)
    live = torch.nonzero(state[ALIVE] > 0.0).squeeze(1)
    for lanes in live.split(_LANE_CHUNK):
        st = {k: state[i, lanes] for i, k in enumerate(PLANES)}
        st["segs"] = torch.zeros_like(st["alive"])
        out = mk._bounce(ctx, st, 8 * depth + 3, rid[lanes], depth_ok, rr_on,
                         closest, occluded)
        state[:, lanes] = torch.stack([out[k] for k in PLANES])
        segs[lanes] = out["segs"]
    return segs


def _fused_bounce_cuda(cms: ClusterMegaScene, state, rid, seed, depth,
                       max_depth, rr, rr_start, nee, mis, clamp, t_min):
    """Launch ``mcpt_torch/csrc/fused_bounce.cu`` on the current stream; it
    updates ``state`` in place.  Raises on a refused launch and on the
    kernel's stack-overflow flag (read back, so this call synchronises)."""
    global LAUNCHES
    from mcpt_torch.kernels import _build

    for name in ("matt", "lit"):
        mk._check_cuda(f"cms.{name}", getattr(cms, name))
    mk._check_cuda("state", state)
    dev = state.device
    if state.dim() != 2 or state.shape[0] != len(PLANES):
        raise ValueError(f"state must be ({len(PLANES)}, N), got "
                         f"{tuple(state.shape)}")
    n = state.shape[1]
    if (rid.device != dev or rid.dtype != torch.int32
            or tuple(rid.shape) != (n,) or not rid.is_contiguous()):
        raise ValueError(f"rid must be a contiguous int32 ({n},) tensor on "
                         f"{dev}")
    cap = _check_walk_tables(cms, dev)
    for t in (cms.matt, cms.lit):
        if t.device != dev:
            raise ValueError(f"tables on {t.device}, state on {dev}")
    segs = torch.empty(n, dtype=torch.float32, device=dev)
    # [0] the stack-overflow flag, [1] the next ray to hand out
    err = torch.zeros(2, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mcpt_fused_bounce(
            cms.wnodes.data_ptr(), cms.tri16.data_ptr(), cms.live.data_ptr(),
            cms.matt.data_ptr(), cms.lit.data_ptr(), cms.wnodes.shape[0],
            cms.leaf_size, cap, cms.n_lights, _f32(cms.eps), _f32(t_min),
            _f32(cms.total_light_area), _f32(clamp), int(seed) & _M32,
            int(depth), int(max_depth), int(bool(rr)), int(rr_start),
            int(bool(nee) and cms.n_lights > 0), int(bool(mis)),
            state.data_ptr(), rid.data_ptr(), segs.data_ptr(), n,
            err.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused-bounce launch failed: CUDA error {rc} "
                           f"({lib.mcpt_error_string(rc).decode()})")
    LAUNCHES += 1
    if int(err[0].item()) != 0:
        raise RuntimeError(f"fused bounce: traversal stack overflow (> {cap}"
                           " entries); collapse_wide should have rejected "
                           "this tree")
    return segs


def fused_bounce(cms: ClusterMegaScene, state: torch.Tensor,
                 rid: torch.Tensor, seed, depth: int, max_depth: int = 8,
                 rr: bool = False, rr_start: int = 3, nee: bool = False,
                 mis: bool = False, clamp: float = 0.0,
                 t_min: float = 1e-4) -> torch.Tensor:
    """One hybrid bounce: updates ``state`` ((16, N) f32) in place and
    returns the (N,) segments.  The device of ``state`` decides: CPU
    tensors run the plain version, CUDA tensors launch the kernel (or
    raise)."""
    args = (cms, state, rid, seed, depth, max_depth, rr, rr_start, nee, mis,
            clamp, t_min)
    kind = state.device.type
    if kind == "cpu":
        return fused_bounce_reference(*args)
    if kind == "cuda":
        return _fused_bounce_cuda(*args)
    raise ValueError(f"fused_bounce runs on cpu or cuda tensors, not {kind}")


# --------------------------------------------------------------------------
# kernel 3, the cluster megakernel: whole paths through the cluster walk
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def tile_pixels(width: int, height: int, device: torch.device):
    """``tile_order(width, height, BLKT)`` on ``device``, computed and
    uploaded once per (width, height, device) → (perm, inv_perm) int64 and
    perm int32: lane i renders pixel perm[i % W·H].  Shared by kernel 3,
    its plain version and the hybrid's ``camera_pool``; nobody writes to
    them."""
    from mcpt_torch.render.camera import tile_order

    perm, inv = tile_order(width, height, block=BLKT)
    perm = torch.from_numpy(perm).to(device, torch.int64)
    return perm, torch.from_numpy(inv).to(device, torch.int64), \
        perm.to(torch.int32)


def render_cluster_mega_reference(cms: ClusterMegaScene, cam: T.Camera,
                                  width: int, height: int, spp: int, seed,
                                  max_depth: int = 8, rr: bool = False,
                                  rr_start: int = 3, nee: bool = False,
                                  mis: bool = False, clamp: float = 0.0,
                                  t_min: float = 1e-4,
                                  schedule: str = "auto"):
    """The plain version of the cluster megakernel → ((W·H, 3) radiance sum
    in pixel order, float64 segment count): the dense megakernel's lane loop
    (``megakernel.render_lanes_reference``) with the cluster walk's
    intersectors and the pixels in tile order.  Its RNG counters are the
    dense ones, so it computes the dense megakernel's and the hybrid's
    streams."""
    regen = mk._resolve_schedule(schedule, spp)
    perm, inv, _ = tile_pixels(width, height, cms.wnodes.device)
    lanes = mk.render_lanes_reference(
        cms, cam, width, height, spp, seed, max_depth, rr, rr_start, nee,
        mis, clamp, t_min, perm, 0, regen, *_walk_pair(cms))
    radiance, segs = mk._reduce(lanes, regen, spp, width * height)
    return radiance[inv].contiguous(), segs


def _render_cluster_mega_cuda(cms: ClusterMegaScene, cam: T.Camera, width,
                              height, spp, seed, max_depth, rr, rr_start, nee,
                              mis, clamp, t_min, schedule):
    """Launch ``mcpt_torch/csrc/cluster_mega.cu`` on the current stream.
    Raises on a refused launch and on the stack-overflow flag (read back,
    so the call synchronises)."""
    global CLUSTER_MEGA_LAUNCHES
    from mcpt_torch.kernels import _build

    regen = mk._resolve_schedule(schedule, spp)
    for name in ("matt", "lit"):
        mk._check_cuda(f"cms.{name}", getattr(cms, name))
    dev = cms.wnodes.device
    cap = _check_walk_tables(cms, dev)
    for t in (cms.matt, cms.lit):
        if t.device != dev:
            raise ValueError(f"tables on {t.device} and {dev}")
    sf = mk._sf(cms, cam, t_min, clamp)
    mk._check_cuda("camera", sf)
    if sf.device != dev:
        raise ValueError(f"camera on {sf.device}, tables on {dev}")
    n_pixels = width * height
    _, inv, pix = tile_pixels(width, height, dev)
    si = mk._si(0, cms.n_mats, cms.n_lights, width, height, spp, seed,
                max_depth, rr, rr_start, n_pixels, 0, 0)
    n_lanes = n_pixels if regen else n_pixels * spp
    out = torch.empty((4, n_lanes), dtype=torch.float32, device=dev)
    # [0] the stack-overflow flag, [1] the next lane to hand out
    err = torch.zeros(2, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mcpt_render_cluster(
            si.ctypes.data, sf.data_ptr(), cms.wnodes.data_ptr(),
            cms.tri16.data_ptr(), cms.live.data_ptr(), cms.wnodes.shape[0],
            cms.leaf_size, cap, cms.matt.data_ptr(), cms.lit.data_ptr(),
            cms.matt.shape[0], cms.lit.shape[0],
            int(nee and cms.n_lights > 0), int(mis), int(regen),
            pix.data_ptr(), n_lanes, out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), out[3].data_ptr(), err.data_ptr(),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"cluster megakernel launch failed: CUDA error "
                           f"{rc} ({lib.mcpt_error_string(rc).decode()})")
    CLUSTER_MEGA_LAUNCHES += 1
    if int(err[0].item()) != 0:
        raise RuntimeError(f"cluster megakernel: traversal stack overflow "
                           f"(> {cap} entries); collapse_wide should have "
                           "rejected this tree")
    radiance, segs = mk._reduce(out, regen, spp, n_pixels)
    return radiance[inv].contiguous(), segs


def render_cluster_mega(cms: ClusterMegaScene, cam: T.Camera, width: int,
                        height: int, spp: int, seed, max_depth: int = 8,
                        rr: bool = False, rr_start: int = 3,
                        nee: bool = False, mis: bool = False,
                        clamp: float = 0.0, t_min: float = 1e-4,
                        schedule: str = "auto"):
    """Render ``spp`` samples with whole paths per lane through the cluster
    walk → ((W·H, 3) radiance sum in pixel order, float64 segment count),
    with ``mcpt.pallas.cluster_megakernel.render_cluster_mega``'s arguments
    (less the TPU-only ``interpret`` and ``subt``).  ``schedule``:
    ``regen`` (one lane per pixel, in-place regeneration), ``batch`` (one
    lane per (sample, pixel)) or ``auto`` (regen when spp > 1).  Lanes take
    their pixels in tile order (``camera.tile_order``, ``BLKT``), so a
    warp's rays start close together.

    The device of the tables decides: CPU tensors run the plain version,
    CUDA tensors launch kernel 3 (or raise)."""
    args = (cms, cam, width, height, spp, seed, max_depth, rr, rr_start, nee,
            mis, clamp, t_min, schedule)
    kind = cms.wnodes.device.type
    if kind == "cpu":
        return render_cluster_mega_reference(*args)
    if kind == "cuda":
        return _render_cluster_mega_cuda(*args)
    raise ValueError(f"render_cluster_mega runs on cpu or cuda tensors, not "
                     f"{kind}")


# --------------------------------------------------------------------------
# the pipeline: camera rays, sort keys, compaction, render
# --------------------------------------------------------------------------


def camera_pool(cms: ClusterMegaScene, cam: T.Camera, width: int,
                height: int, spp: int, seed, n_pool: int):
    """The step's flat pool → ((16, n_pool) state, (n_pool,) int32 rid).

    Sample-major lanes over the tile-ordered pixels (``_xla_camera_rays``:
    the dense megakernel's ``cam_ray`` with the same (sample, pixel) RNG
    streams, ``rsqrt`` written as ``1/sqrt``).  Pad lanes are dead, and
    their ids start at ``spp·W·H`` so the final id sort puts them last."""
    dev = cms.wnodes.device
    perm, _, _ = tile_pixels(width, height, dev)
    n_px, total = perm.numel(), width * height
    n_rays = n_px * spp
    pix = perm.repeat(spp)
    smp = torch.arange(spp, device=dev).repeat_interleave(n_px)
    idx = (smp * total + pix) & _M32
    sf = [float(x) for x in mk._sf(cms, cam, 0.0, 0.0).cpu().tolist()]
    ctx = mk._Ctx(mega=cms, cdf=None, seed=int(seed) & _M32, sf=sf,
                  use_nee=False, use_mis=False)
    o, d = mk._cam_ray(ctx, (pix % width).to(torch.float32),
                       (pix // width).to(torch.float32), width, height, idx)

    state = torch.zeros((len(PLANES), n_pool), dtype=torch.float32,
                        device=dev)
    for j in range(3):
        state[j, :n_rays] = o[j]
        state[3 + j, :n_rays] = d[j]
    state[3, n_rays:] = 1.0  # pad direction (1, 0, 0), as mcpt pads
    state[6:9, :n_rays] = 1.0  # throughput
    state[ALIVE, :n_rays] = 1.0
    pad = spp * total + torch.arange(n_pool - n_rays, device=dev)
    rid = torch.cat([idx, pad]).to(torch.int32)
    return state, rid


def _hybrid_sort_key(ox, oy, oz, dx, dy, dz, alive, bb_lo, bb_inv_ext,
                     key_mode: str = "cell"):
    """Coherence key (int32, < 2³¹) on flat planes, dead rays last
    (``DEAD_KEY``).  ``key_mode``: ``cell`` (coarse origin cell | octant |
    fine origin), ``dir`` (octant | coarse | fine), ``dir6`` (2-bit
    direction cell per axis | coarse | fine), ``dir9`` (3 bits per axis,
    fine bits shortened to stay in 31 bits).  The coarse cell has
    ``COARSE_BITS`` Morton bits, as in ``mcpt``."""
    coarse_bits = COARSE_BITS
    u = torch.stack([
        torch.clamp((ox - bb_lo[0]) * bb_inv_ext[0], 0.0, 0.999999),
        torch.clamp((oy - bb_lo[1]) * bb_inv_ext[1], 0.0, 0.999999),
        torch.clamp((oz - bb_lo[2]) * bb_inv_ext[2], 0.0, 0.999999),
    ], dim=-1)
    m = morton30(u)
    octant = _octant(dx, dy, dz)
    fine_bits = min(30 - coarse_bits, 12)
    coarse = m >> (30 - coarse_bits)
    fine = (m >> (30 - coarse_bits - fine_bits)) & ((1 << fine_bits) - 1)

    def cell(c, scale, top):  # direction cell per axis, c in [-1, 1]
        return torch.clamp(((c + 1.0) * scale).to(torch.int64), 0, top)

    if key_mode == "cell":
        key = (coarse << (3 + fine_bits)) | (octant << fine_bits) | fine
    elif key_mode == "dir":
        key = ((octant << (coarse_bits + fine_bits)) | (coarse << fine_bits)
               | fine)
    elif key_mode == "dir6":
        d6 = (cell(dx, 2.0, 3) << 4) | (cell(dy, 2.0, 3) << 2) | cell(dz, 2.0,
                                                                      3)
        key = (d6 << (coarse_bits + fine_bits)) | (coarse << fine_bits) | fine
    elif key_mode == "dir9":
        d9 = (cell(dx, 4.0, 7) << 6) | (cell(dy, 4.0, 7) << 3) | cell(dz, 4.0,
                                                                      7)
        fb9 = min(fine_bits, 30 - 9 - coarse_bits)
        key = ((d9 << (coarse_bits + fb9)) | (coarse << fb9)
               | (fine >> (fine_bits - fb9)))
    else:
        raise ValueError(f"unknown key_mode {key_mode!r}")
    return torch.where(alive > 0.5, key, DEAD_KEY).to(torch.int32)


def resolve_key_mode(key_mode: str, compact: tuple | None) -> str:
    """``auto`` → ``dir6`` when the pilot's live shares all stay ≥ 0.8
    (closed interiors: incoherent diffuse bounces dominate the walk), else
    ``cell`` (open scenes: early origin-coherent bounces dominate); ``dir6``
    without a schedule.  ``mcpt``'s rule, measured on its TPU."""
    if key_mode != "auto":
        return key_mode
    live = tuple(compact) if compact else ()
    return "dir6" if (not live or min(live) >= 0.8) else "cell"


def _compaction_schedule(rows0, max_depth, compact):
    """Pool height (rows of 128 lanes) each depth's bounce runs at.  Caps
    quantise up to a pow2 × {1, 1.25, 1.5, 1.75} grid (``mcpt``'s bound on
    distinct kernel shapes) and to a multiple of ``SUBT``."""
    rows_at = []
    cur_rows = rows0
    for depth in range(max_depth):
        rows_at.append(cur_rows)
        if depth + 1 < max_depth and compact is not None:
            frac = compact[min(depth, len(compact) - 1)]
            want = max(1.0, frac * rows0)
            oct_ = math.floor(math.log2(want))
            cap_rows = cur_rows
            for mult in (1.0, 1.25, 1.5, 1.75, 2.0):
                lvl = (2 ** oct_) * mult
                if lvl >= want:
                    cap_rows = int(lvl)
                    break
            cap_rows = max(SUBT, -(-cap_rows // SUBT) * SUBT)
            cur_rows = min(cur_rows, cap_rows)
    return rows_at


def _roulette(state, rid, seed, depth: int, live_cap: float) -> None:
    """Bernoulli selection toward ``live_cap`` live lanes, in place:
    survivors with probability p = min(1, cap / live) (RNG salt
    ``1009 + depth``) carry throughput × 1/p — unbiased."""
    dev = state.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    alive = state[ALIVE] > 0.0
    live = alive.to(torch.float32).sum()
    cap = torch.tensor(np.float32(live_cap), device=dev)
    p = torch.minimum(one, cap / torch.maximum(live, one))
    u = mk._u01(seed, 1009 + depth, rid)
    state[ALIVE] = (alive & (u < p)).to(torch.float32)
    state[6:9] *= 1.0 / p


class _NoTimer:
    """Stands in for ``runtime.StageTimer`` when nothing is timed."""

    @staticmethod
    def stage(name):
        return contextlib.nullcontext()

    @staticmethod
    def sync(*tensors):
        pass


def _run_hybrid(cms, cam, width, height, spp, seed, max_depth=8, rr=False,
                rr_start=3, nee=False, mis=False, clamp=0.0, t_min=1e-4,
                compact=None, key_mode="auto", timer=None, live=None,
                bounce=None):
    """The pipeline of ``_render_hybrid_jit`` as a loop over depths →
    ((W·H, 3) radiance sum in pixel order, float64 0-d segment count).

    ``timer`` (a ``StageTimer``) times each stage with a device sync;
    ``live`` (a list) receives the live share of the pool after each bounce
    but the last (the pilot's measurement); ``bounce`` replaces
    ``fused_bounce`` (``render_hybrid_reference`` passes the plain one)."""
    bounce = fused_bounce if bounce is None else bounce
    key_mode = resolve_key_mode(key_mode, compact)
    timer = timer if timer is not None else _NoTimer
    dev = cms.wnodes.device
    n_px = width * height
    n_rays = n_px * spp
    rows0 = -(-n_rays // BLKT) * SUBT
    with timer.stage("raygen"):
        state, rid = camera_pool(cms, cam, width, height, spp, seed,
                                 rows0 * 128)
        timer.sync(state)

    rows_at = _compaction_schedule(rows0, max_depth, compact)
    segs_total = torch.zeros((), dtype=torch.float64, device=dev)
    tails = []  # dropped (rid, radiance) of compacted-away lanes
    for d in range(max_depth):
        with timer.stage(f"bounce[d{d}]  ({rows_at[d]}×128 pool)"):
            segs = bounce(cms, state, rid, seed, d, max_depth, rr, rr_start,
                          nee, mis, clamp, t_min)
            timer.sync(state)
        segs_total = segs_total + segs.to(torch.float64).sum()
        if live is not None and d + 1 < max_depth:
            live.append(float(state[ALIVE].sum()) / n_rays)
        shrink = d + 1 < max_depth and rows_at[d + 1] < rows_at[d]
        if shrink:
            # 97% of the next pool's lanes: the 3% Bernoulli margin
            with timer.stage("roulette"):
                _roulette(state, rid, seed, d, 0.97 * rows_at[d + 1] * 128)
                timer.sync(state)
        if d + 1 == max_depth:
            break  # the final reduce orders the lanes by id anyway
        with timer.stage(f"sort[d{d}]"):
            key = _hybrid_sort_key(*state[:6], state[ALIVE], cms.bb_lo,
                                   cms.bb_inv_ext, key_mode)
            order = torch.sort(key, stable=True).indices
            if shrink:
                # dead rays sort last, so the dropped tail is all dead; its
                # radiance rides to the final reduce.  A live ray there (the
                # 3% margin blown, P < 1e-200) poisons the segment count
                # instead of silently biasing the image.
                tail = order[rows_at[d + 1] * 128:]
                tail_alive = state[ALIVE, tail].sum()
                segs_total = segs_total + torch.where(
                    tail_alive > 0.0, math.nan, 0.0).to(torch.float64)
                tails.append((rid[tail], state[9:12, tail]))
                order = order[:rows_at[d + 1] * 128]
            state = state.index_select(1, order)
            rid = rid[order]
            timer.sync(state)

    # restore (sample, pixel) order by RNG id, then sum over samples
    with timer.stage("final-reduce"):
        ids = torch.cat([t[0] for t in tails] + [rid])
        rad = torch.cat([t[1] for t in tails] + [state[9:12]], dim=1)
        order = torch.sort(ids, stable=True).indices[:n_rays]
        radiance = rad[:, order].t().reshape(spp, n_px, 3).sum(dim=0)
        timer.sync(radiance)
    return radiance.contiguous(), segs_total


def render_hybrid(cms: ClusterMegaScene, cam: T.Camera, width: int,
                  height: int, spp: int, seed, max_depth: int = 8,
                  rr: bool = False, rr_start: int = 3, nee: bool = False,
                  mis: bool = False, clamp: float = 0.0, t_min: float = 1e-4,
                  compact: tuple | None = None, key_mode: str = "auto"):
    """Hybrid fused-bounce render of ``spp`` samples → ((W·H, 3) radiance
    sum, float64 0-d segment count), with ``mcpt.pallas.cluster_megakernel
    .render_hybrid``'s arguments, less the TPU-only ``interpret`` and
    ``subt`` and the tuning knobs no caller of ``mcpt``'s sets
    (``coarse_bits`` is ``COARSE_BITS``; every bounce but the last re-sorts,
    ``resort_every=1``).

    ``compact``: per-depth live-share caps (entry d caps the pool entering
    bounce d+1); the pool shrinks by a prefix slice after the sort, with
    Bernoulli roulette when more paths live than a cap allows (unbiased: a
    tight cap costs variance, never bias).  ``key_mode="auto"`` resolves
    from ``compact`` (``resolve_key_mode``).  The tables' device decides
    where it runs; the bounces go through ``fused_bounce``."""
    return _run_hybrid(cms, cam, width, height, spp, seed, max_depth, rr,
                       rr_start, nee, mis, clamp, t_min, compact, key_mode)


def render_hybrid_reference(cms: ClusterMegaScene, cam: T.Camera,
                            width: int, height: int, spp: int, seed, **kw):
    """``render_hybrid`` (same arguments) with every bounce through the
    plain ``fused_bounce_reference``, on whatever device the tables are: on
    CUDA tensors it is the whole pipeline the kernel is held against."""
    return _run_hybrid(cms, cam, width, height, spp, seed,
                       bounce=fused_bounce_reference, **kw)


def profile_hybrid(cms: ClusterMegaScene, cam: T.Camera, width: int,
                   height: int, spp: int, seed, timer=None, **kw):
    """``render_hybrid`` (same arguments) with every stage timed and
    synchronised → (timer, radiance, segments): raygen, each bounce with
    its pool height, roulette, each sort and the final reduce (the
    breakdown behind the CLI's ``--profile``).  Same arithmetic, so the
    same bits."""
    from mcpt_torch.runtime import StageTimer

    timer = timer if timer is not None else StageTimer()
    radiance, segs = _run_hybrid(cms, cam, width, height, spp, seed,
                                 timer=timer, **kw)
    return timer, radiance, segs
