"""State conversion between ``mcpt`` (JAX) and ``mcpt_torch``.

``mcpt``'s state is handed over as numpy arrays (``np.asarray`` of each JAX
field), so this module needs neither JAX nor ``mcpt``.  Field names are the
same on both sides: ``MegaScene`` tables (``tri, cbox, matt, lit`` plus the
scalar fields), ``ClusterBVH`` (``nodes, wnodes, tri16, tri_map``),
``ClusterMegaScene`` (its tables, scalars and scene-box tuples), ``Camera``,
``Framebuffer``, and the wavefront's ``RayPool`` and ``Hit``; a threefry key
crosses as its two words (``jax.random.key_data``).  The cluster tables'
port-only fields (``live``, ``wide_depth``) are read off ``mcpt``'s tables
on the way in (``cluster.live_rows``, ``cluster.wide_depth``) and left out on
the way back.  A test can so feed ``mcpt``'s own tables to the port's
engines.  The CLI checkpoint is the
``.ckpt.npz`` that ``tools/render.py`` writes — ``{sum, count, done}`` — so a
render checkpointed by either CLI resumes under the other.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mcpt_torch.bvh import cluster as cluster_mod
from mcpt_torch.bvh.cluster import MCPT_FIELDS, ClusterBVH
from mcpt_torch.kernels.cluster_megakernel import ClusterMegaScene
from mcpt_torch.kernels.megakernel import MegaScene
from mcpt_torch.rng import Key
from mcpt_torch.types import Camera, Framebuffer, Hit, RayPool

_SCALAR_FIELDS = {"n_tris": int, "n_mats": int, "n_lights": int,
                  "eps": float, "total_light_area": float}
_CLUSTER_SCALARS = {"n_clusters": int, "leaf_size": int, "n_mats": int,
                    "n_lights": int, "eps": float, "total_light_area": float,
                    "bb_lo": lambda v: tuple(float(x) for x in np.ravel(v)),
                    "bb_inv_ext": lambda v: tuple(float(x)
                                                  for x in np.ravel(v))}


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def megascene_from_numpy(fields: Mapping, device) -> MegaScene:
    """``mcpt.pallas.megakernel.MegaScene`` fields (arrays and scalars) →
    the port's ``MegaScene`` on ``device``."""
    return MegaScene(**{
        k: (_SCALAR_FIELDS[k](fields[k]) if k in _SCALAR_FIELDS
            else _tensor(np.asarray(fields[k], np.float32), device))
        for k in MegaScene._fields
    })


def megascene_to_numpy(mega: MegaScene) -> dict:
    return {k: (v if k in _SCALAR_FIELDS else _numpy(v))
            for k, v in mega._asdict().items()}


def _port_fields(wnodes, tri16, leaf_size: int, device) -> dict:
    live = cluster_mod.live_rows(tri16, leaf_size)
    return {"live": _tensor(live, device),
            "wide_depth": cluster_mod.wide_depth(wnodes)}


def clusterbvh_from_numpy(fields: Mapping, device) -> ClusterBVH:
    """``mcpt.bvh.cluster.ClusterBVH`` fields → the port's, on ``device``
    (``tri_map`` int32, the rest f32, and the port's own fields)."""
    t = {k: _tensor(np.asarray(fields[k],
                               np.int32 if k == "tri_map" else np.float32),
                    device)
         for k in MCPT_FIELDS}
    n_clusters = (t["nodes"].shape[0] + 1) // 2
    return ClusterBVH(**t, **_port_fields(
        fields["wnodes"], fields["tri16"],
        t["tri16"].shape[0] // n_clusters, device))


def clusterbvh_to_numpy(cl: ClusterBVH) -> dict:
    return {k: _numpy(getattr(cl, k)) for k in MCPT_FIELDS}


def clustermegascene_from_numpy(fields: Mapping, device) -> ClusterMegaScene:
    """``mcpt.pallas.cluster_megakernel.ClusterMegaScene`` fields (arrays,
    scalars and the scene-box tuples) → the port's on ``device``, with the
    port's own fields."""
    port = _port_fields(fields["wnodes"], fields["tri16"],
                        int(fields["leaf_size"]), device)
    return ClusterMegaScene(**{
        k: (port[k] if k in port
            else _CLUSTER_SCALARS[k](fields[k]) if k in _CLUSTER_SCALARS
            else _tensor(np.asarray(fields[k], np.float32), device))
        for k in ClusterMegaScene._fields})


def clustermegascene_to_numpy(cms: ClusterMegaScene) -> dict:
    """``mcpt``'s fields of ``cms`` (not the port's ``live``,
    ``wide_depth``)."""
    return {k: (v if k in _CLUSTER_SCALARS else _numpy(v))
            for k, v in cms._asdict().items()
            if k not in ("live", "wide_depth")}


def camera_from_numpy(fields: Mapping, device) -> Camera:
    return Camera(**{k: _tensor(np.asarray(fields[k], np.float32), device)
                     for k in Camera._fields})


def camera_to_numpy(cam: Camera) -> dict:
    return {k: _numpy(v) for k, v in cam._asdict().items()}


def framebuffer_from_numpy(sum_, count, device) -> Framebuffer:
    return Framebuffer(sum=_tensor(np.asarray(sum_, np.float32), device),
                       count=_tensor(np.asarray(count, np.float32), device))


def framebuffer_to_numpy(fb: Framebuffer) -> dict:
    return {"sum": _numpy(fb.sum), "count": _numpy(fb.count)}


_INT32 = ("pixel", "tri")
_BOOL = ("alive", "inside")


def _field(k, v, device) -> torch.Tensor:
    dtype = (np.int32 if k in _INT32 else np.bool_ if k in _BOOL
             else np.float32)
    return _tensor(np.asarray(v, dtype), device)


def raypool_from_numpy(fields: Mapping, device) -> RayPool:
    """``mcpt.types.RayPool`` fields → the port's on ``device``."""
    return RayPool(**{k: _field(k, fields[k], device)
                      for k in RayPool._fields})


def raypool_to_numpy(pool: RayPool) -> dict:
    return {k: _numpy(v) for k, v in pool._asdict().items()}


def hit_from_numpy(fields: Mapping, device) -> Hit:
    """``mcpt.types.Hit`` fields → the port's on ``device``."""
    return Hit(**{k: _field(k, fields[k], device) for k in Hit._fields})


def hit_to_numpy(hit: Hit) -> dict:
    return {k: _numpy(v) for k, v in hit._asdict().items()}


def key_from_data(words) -> Key:
    """The two uint32 words of ``jax.random.key_data(k)`` → the port's
    threefry ``Key``."""
    k1, k2 = (int(x) & 0xFFFFFFFF for x in np.ravel(np.asarray(words)))
    return Key(k1, k2)


def load_checkpoint(path: str, device) -> tuple[Framebuffer, int]:
    """A ``{sum, count, done}`` checkpoint → (framebuffer, samples done)."""
    with np.load(path) as z:
        return (framebuffer_from_numpy(z["sum"], z["count"], device),
                int(z["done"]))


def save_checkpoint(path: str, fb: Framebuffer, done: int) -> None:
    """Write the checkpoint in ``tools/render.py``'s format."""
    np.savez(path, **framebuffer_to_numpy(fb), done=done)
