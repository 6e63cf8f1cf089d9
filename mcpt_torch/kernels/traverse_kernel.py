"""Kernel 4: the wavefront engine's cluster-BVH traversal, closest hit and
any-hit, one ray per lane.

Port of ``mcpt/pallas/traverse_kernel.py`` (``_traverse_jit`` at :303, its
``pallas_call`` at :333; public ``intersect_clusters`` :394 and
``occluded_clusters`` :423), with ``mcpt``'s contracts:

- ``intersect_clusters`` → ``types.Hit``: the closest hit in
  (t_min, t_max), ``tri = tri_map[row]``, the normal from
  ``tri16[row, 12:15]``; t = inf and tri = -1 on a miss or an inactive ray;
- ``occluded_clusters`` → bool: a hit in (t_min, t_max) on an active ray.

Three layers: ``traverse_reference``, the plain version (``walk_reference``
of the hybrid engine, one stack per ray, run on the active rays only), with
``hit_from_rows`` building its ``Hit``; ``_traverse_cuda``, which launches
``mcpt_torch/csrc/traverse.cu`` (its closest hit writes the ``Hit`` itself);
and the dispatch through ``_build.use_kernel``: CPU tensors run the plain
version, CUDA tensors launch the kernel, anything else raises.  Nothing
falls back.  The kernel's stack-overflow flag is read back after each
launch, or once at the end of a ``_build.overflow_checked_once`` block (the
wavefront's bounce loops): the block lives in the launch seam,
``kernels/_build.py``, which kernel 2's flag goes through too.

Two TPU workarounds stay behind: the 4096-row segment loop (scoped VMEM)
and the 2e38 origin poison of inactive lanes (a block walks the union of
its lanes' nodes).  Here an inactive ray simply exits.
"""

from __future__ import annotations

import math

import torch

from mcpt_torch.kernels import _build
from mcpt_torch.kernels import cluster_megakernel as cmk
from mcpt_torch.trace import spanned
from mcpt_torch.types import Hit

_MISS = 3.0e38  # t of a miss in the raw outputs (the kernels' kMiss)


def traverse_reference(cl, origin, direction, active, limit, any_hit: bool,
                       t_min: float = 1e-4):
    """The plain version over (R, 3) rays, an (R,) bool ``active`` mask and
    (R,) per-ray limits → any-hit: (R,) bool; closest hit: (t (R,) with
    3e38 on a miss, row (R,) int32 with -1 on a miss, normal (R, 3))."""
    r = origin.shape[0]
    dev = origin.device
    idx = torch.nonzero(active).squeeze(1)
    ray = (*origin[idx].unbind(1), *direction[idx].unbind(1))
    lim = limit[idx]
    if any_hit:
        occ = torch.zeros((r,), dtype=torch.bool, device=dev)
        occ[idx] = cmk.walk_tables(cl, *ray, t_min, lim)
        return occ
    best_t, best_row = cmk.walk_tables(cl, *ray, t_min)
    hit = best_t < lim  # the closest hit overall, if it lies below the limit
    t = torch.full((r,), _MISS, dtype=torch.float32, device=dev)
    row = torch.full((r,), -1, dtype=torch.int32, device=dev)
    normal = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    t[idx] = torch.where(hit, best_t, _MISS)
    row[idx] = torch.where(hit, best_row, -1).to(torch.int32)
    normal[idx] = torch.where(hit[:, None], cl.tri16[best_row, 12:15], 0.0)
    return t, row, normal


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    _build.check_cuda(name, t, dtype)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _traverse_cuda(cl, origin, direction, active, limit, any_hit: bool,
                   t_min: float = 1e-4):
    """Launch ``mcpt_torch/csrc/traverse.cu`` on the current stream.  Any
    hit → (R,) bool, ``traverse_reference``'s; closest hit → ``types.Hit``,
    ``intersect_clusters``'s (``limit`` may be None: no limit).  Raises on
    a refused launch and on the kernel's stack-overflow flag: read back at
    once (the call then synchronises), or inside
    ``_build.overflow_checked_once`` at the block's end."""
    r = origin.shape[0]
    dev = origin.device
    _check("origin", origin, torch.float32, (r, 3))
    _check("direction", direction, torch.float32, (r, 3))
    _check("active", active, torch.bool, (r,))
    if limit is None and any_hit:
        raise ValueError("the any hit needs a limit a ray")
    if limit is not None:
        _check("limit", limit, torch.float32, (r,))
    for t in (direction, active, limit, cl.tri_map):
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    cap = cmk._check_walk_tables(cl, dev)
    _check("tri_map", cl.tri_map, torch.int32, (cl.tri16.shape[0],))
    err = _build.overflow_flag("mcpt_traverse", dev, cap)
    if any_hit:
        occ = torch.empty((r,), dtype=torch.bool, device=dev)
        outs = (None, None, None, None, occ.data_ptr())
    else:
        hit = Hit(t=torch.empty((r,), dtype=torch.float32, device=dev),
                  tri=torch.empty((r,), dtype=torch.int32, device=dev),
                  point=torch.empty((r, 3), dtype=torch.float32, device=dev),
                  normal=torch.empty((r, 3), dtype=torch.float32,
                                     device=dev))
        outs = (*(x.data_ptr() for x in hit), None)
    _build.launch(
        "mcpt_traverse", dev, cl.wnodes.data_ptr(), cl.tri16.data_ptr(),
        cl.live.data_ptr(), cl.tri_map.data_ptr(), cl.wnodes.shape[0],
        cl.leaf_size, cap, origin.data_ptr(), direction.data_ptr(),
        active.data_ptr(), None if limit is None else limit.data_ptr(),
        float(t_min), int(any_hit), *outs, r, err.data_ptr())
    _build.check_overflow("mcpt_traverse", err, cap)
    return occ if any_hit else hit


def _limits(t_max, r: int, dev) -> torch.Tensor:
    if t_max is None:
        return torch.full((r,), _MISS, dtype=torch.float32, device=dev)
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                              device=dev), (r,))


def _active(active, r: int, dev) -> torch.Tensor:
    if active is None:
        return torch.ones((r,), dtype=torch.bool, device=dev)
    return active.to(torch.bool)


def hit_from_rows(cl, origin, direction, t, row, normal) -> Hit:
    """``traverse_reference``'s closest hit → ``types.Hit``: t = inf and
    tri = -1 on a miss, ``tri = tri_map[row]``, ``point = origin +
    direction · t`` (t read as 0 on a miss), the normal 0 on a miss.  The
    kernel writes these fields itself."""
    valid = row >= 0
    tri = torch.where(valid, cl.tri_map[torch.clamp(row, min=0).long()], -1)
    t = torch.where(valid, t, math.inf)
    point = origin + direction * torch.where(valid, t, 0.0)[:, None]
    return Hit(t=t, tri=tri.to(torch.int32), point=point,
               normal=torch.where(valid[:, None], normal, 0.0))


@spanned("mcpt.wavefront.closest_hit")
def intersect_clusters(cl, origin, direction, active=None, t_max=None,
                       t_min: float = 1e-4) -> Hit:
    """Closest hit over the cluster BVH ``cl`` → ``types.Hit``; a drop-in
    for ``traverse.intersect_bvh`` on clustered scenes.  Ties keep the
    lowest (t, tri16 row), so the answer is brute force over ``tri16``."""
    r = origin.shape[0]
    dev = origin.device
    act = _active(active, r, dev)
    if _build.use_kernel("intersect_clusters", origin):
        lim = (None if t_max is None
               else _limits(t_max, r, dev).contiguous())
        return _traverse_cuda(cl, origin.contiguous(),
                              direction.contiguous(), act.contiguous(), lim,
                              False, t_min)
    t, row, normal = traverse_reference(cl, origin, direction, act,
                                        _limits(t_max, r, dev), False, t_min)
    return hit_from_rows(cl, origin, direction, t, row, normal)


@spanned("mcpt.wavefront.any_hit")
def occluded_clusters(cl, origin, direction, t_max, active=None,
                      t_min: float = 1e-4) -> torch.Tensor:
    """Any-hit query: True where a triangle lies in (t_min, t_max) on an
    active ray (an inactive ray is never occluded).  Each ray's walk ends
    at its first hit."""
    r = origin.shape[0]
    dev = origin.device
    act = _active(active, r, dev)
    lim = _limits(t_max, r, dev)
    if _build.use_kernel("occluded_clusters", origin):
        return _traverse_cuda(cl, origin.contiguous(), direction.contiguous(),
                              act.contiguous(), lim.contiguous(), True, t_min)
    return traverse_reference(cl, origin, direction, act, lim, True, t_min)
