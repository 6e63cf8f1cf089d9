"""Kernel 4: the wavefront engine's cluster-BVH traversal, closest hit and
any-hit, one ray per lane.

Port of ``mcpt/pallas/traverse_kernel.py`` (``_traverse_jit`` at :303, its
``pallas_call`` at :333; public ``intersect_clusters`` :394 and
``occluded_clusters`` :423), with ``mcpt``'s contracts:

- ``intersect_clusters`` → ``types.Hit``: the closest hit in
  (t_min, t_max), ``tri = tri_map[row]``, the normal from
  ``tri16[row, 12:15]``; t = inf and tri = -1 on a miss or an inactive ray;
- ``occluded_clusters`` → bool: a hit in (t_min, t_max), ``& active``.

Three layers: ``traverse_reference``, the plain version (``walk_reference``
of the hybrid engine, one stack per ray, run on the active rays only);
``_traverse_cuda``, which launches ``mcpt_torch/csrc/traverse.cu``; and the
dispatch in ``_traverse``: CPU tensors run the plain version, CUDA tensors
launch the kernel, anything else raises.  Nothing falls back.

Two TPU workarounds stay behind: the 4096-row segment loop (scoped VMEM)
and the 2e38 origin poison of inactive lanes (a block walks the union of
its lanes' nodes).  Here an inactive ray simply exits.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from mcpt_torch.kernels import cluster_megakernel as cmk
from mcpt_torch.types import Hit

_MISS = 3.0e38  # t of a miss in the raw outputs (the kernels' kMiss)

# kernel launches made on CUDA tensors (never the plain version's calls) —
# read by chip_smoke.py to show the main path used the kernel
LAUNCHES = 0
_PLAIN_ON_CUDA = False


@contextlib.contextmanager
def plain_version_on_cuda():
    """Inside this block CUDA tensors run the plain version instead of the
    kernel: how a whole wavefront render is held against its plain version
    on the card.  Nothing else sets it."""
    global _PLAIN_ON_CUDA
    saved, _PLAIN_ON_CUDA = _PLAIN_ON_CUDA, True
    try:
        yield
    finally:
        _PLAIN_ON_CUDA = saved


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
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _traverse_cuda(cl, origin, direction, active, limit, any_hit: bool,
                   t_min: float = 1e-4):
    """Launch ``mcpt_torch/csrc/traverse.cu`` on the current stream; the
    outputs are ``traverse_reference``'s.  Raises on a refused launch and on
    the kernel's stack-overflow flag (read back, so the call synchronises)."""
    global LAUNCHES
    from mcpt_torch.kernels import _build

    r = origin.shape[0]
    dev = origin.device
    _check("origin", origin, torch.float32, (r, 3))
    _check("direction", direction, torch.float32, (r, 3))
    _check("active", active, torch.bool, (r,))
    _check("limit", limit, torch.float32, (r,))
    for t in (direction, active, limit):
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    cap = cmk._check_walk_tables(cl, dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    if any_hit:
        occ = torch.empty((r,), dtype=torch.bool, device=dev)
        outs = (None, None, None, occ.data_ptr())
    else:
        t_out = torch.empty((r,), dtype=torch.float32, device=dev)
        row = torch.empty((r,), dtype=torch.int32, device=dev)
        normal = torch.empty((r, 3), dtype=torch.float32, device=dev)
        outs = (t_out.data_ptr(), row.data_ptr(), normal.data_ptr(), None)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mcpt_traverse(
            cl.wnodes.data_ptr(), cl.tri16.data_ptr(), cl.live.data_ptr(),
            cl.wnodes.shape[0], cl.leaf_size, cap,
            origin.data_ptr(), direction.data_ptr(), active.data_ptr(),
            limit.data_ptr(), float(t_min), int(any_hit), *outs, r,
            err.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"traverse launch failed: CUDA error {rc} "
                           f"({lib.mcpt_error_string(rc).decode()})")
    LAUNCHES += 1
    if int(err.item()) != 0:
        raise RuntimeError(f"traverse: stack overflow (> {cap} entries); "
                           "collapse_wide should have rejected this tree")
    return occ if any_hit else (t_out, row, normal)


def _traverse(cl, origin, direction, active, limit, any_hit, t_min):
    kind = origin.device.type
    if kind == "cpu" or (kind == "cuda" and _PLAIN_ON_CUDA):
        return traverse_reference(cl, origin, direction, active, limit,
                                  any_hit, t_min)
    if kind == "cuda":
        return _traverse_cuda(cl, origin.contiguous(),
                              direction.contiguous(), active.contiguous(),
                              limit.contiguous(), any_hit, t_min)
    raise ValueError(f"cluster traversal runs on cpu or cuda tensors, not "
                     f"{kind}")


def _limits(t_max, r: int, dev) -> torch.Tensor:
    if t_max is None:
        return torch.full((r,), _MISS, dtype=torch.float32, device=dev)
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                              device=dev), (r,))


def _active(active, r: int, dev) -> torch.Tensor:
    if active is None:
        return torch.ones((r,), dtype=torch.bool, device=dev)
    return active.to(torch.bool)


def intersect_clusters(cl, origin, direction, active=None, t_max=None,
                       t_min: float = 1e-4) -> Hit:
    """Closest hit over the cluster BVH ``cl`` → ``types.Hit``; a drop-in
    for ``traverse.intersect_bvh`` on clustered scenes.  Ties keep the
    lowest (t, tri16 row), so the answer is brute force over ``tri16``."""
    r = origin.shape[0]
    dev = origin.device
    t, row, normal = _traverse(cl, origin, direction, _active(active, r, dev),
                               _limits(t_max, r, dev), False, t_min)
    valid = row >= 0
    tri = torch.where(valid, cl.tri_map[torch.clamp(row, min=0).long()], -1)
    t = torch.where(valid, t, math.inf)
    point = origin + direction * torch.where(valid, t, 0.0)[:, None]
    return Hit(t=t, tri=tri.to(torch.int32), point=point,
               normal=torch.where(valid[:, None], normal, 0.0))


def occluded_clusters(cl, origin, direction, t_max, active=None,
                      t_min: float = 1e-4) -> torch.Tensor:
    """Any-hit query: True where a triangle lies in (t_min, t_max) on an
    active ray.  Each ray's walk ends at its first hit."""
    r = origin.shape[0]
    dev = origin.device
    act = _active(active, r, dev)
    occ = _traverse(cl, origin, direction, act, _limits(t_max, r, dev), True,
                    t_min)
    return occ & act

