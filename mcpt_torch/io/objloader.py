"""Wavefront .obj/.mtl loading — the subset the reference consumes.

The port's counterpart of ``mcpt/io/objloader.py`` (its pure-Python path):
triangulated positions only, per-face material ids, and the reference's 4-way
material classification (``thirdpartywrapper.cpp:65-97``):

1. ``Ni != 1``                     → TRANSPARENT (keeps only Ni)
2. else ``Ka > 0`` (any channel)   → LIGHT (ka = emission)
3. else ``Ns != 1``                → GLOSSY (ks, Ns, kd)
4. else                            → DIFFUSE (kd)

``mcpt``'s native C++ loader is a speed path with the same output arrays; the
port reads files in Python until a large scene needs more.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from mcpt_torch import types

# tinyobjloader defaults when a key is absent from the .mtl (tiny_obj_loader.h
# InitMaterial): ambient/diffuse/specular = 0, shininess = 1, ior = 1.
_MTL_DEFAULTS = dict(
    Ka=(0.0, 0.0, 0.0), Kd=(0.0, 0.0, 0.0), Ks=(0.0, 0.0, 0.0), Ns=1.0, Ni=1.0
)


@dataclasses.dataclass
class RawMaterial:
    name: str
    Ka: tuple = _MTL_DEFAULTS["Ka"]
    Kd: tuple = _MTL_DEFAULTS["Kd"]
    Ks: tuple = _MTL_DEFAULTS["Ks"]
    Ns: float = _MTL_DEFAULTS["Ns"]
    Ni: float = _MTL_DEFAULTS["Ni"]


@dataclasses.dataclass
class LoadedObject:
    """Host-side load result: numpy only."""

    verts: np.ndarray  # (N, 3, 3) f32
    mat_id: np.ndarray  # (N,) int32
    mtype: np.ndarray  # (M,) int32
    kd: np.ndarray  # (M, 3) f32
    ks: np.ndarray  # (M, 3) f32
    ka: np.ndarray  # (M, 3) f32
    ns: np.ndarray  # (M,) f32
    ni: np.ndarray  # (M,) f32
    mat_names: list[str]

    def to_device(self, device):
        geom = types.geometry_from_verts(self.verts, self.mat_id, device)
        mats = types.materials_from_numpy(
            self.mtype, self.kd, self.ks, self.ka, self.ns, self.ni, device
        )
        return geom, mats


def parse_mtl(path: str) -> list[RawMaterial]:
    mats: list[RawMaterial] = []
    cur: RawMaterial | None = None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "newmtl":
                cur = RawMaterial(name=tok[1] if len(tok) > 1 else "")
                mats.append(cur)
            elif cur is None:
                continue
            elif key in ("Ka", "Kd", "Ks"):
                setattr(cur, key, tuple(float(x) for x in tok[1:4]))
            elif key == "Ns":
                cur.Ns = float(tok[1])
            elif key == "Ni":
                cur.Ni = float(tok[1])
            # Tf/illum/d/map_* are unused by the reference loader
    return mats


def classify_materials(raw: list[RawMaterial]):
    """The reference's 4-way classification (``thirdpartywrapper.cpp:65-97``)."""
    m = len(raw)
    mtype = np.zeros(m, np.int32)
    kd = np.zeros((m, 3), np.float32)
    ks = np.zeros((m, 3), np.float32)
    ka = np.zeros((m, 3), np.float32)
    ns = np.zeros(m, np.float32)
    ni = np.ones(m, np.float32)
    for i, r in enumerate(raw):
        if r.Ni != 1.0:
            mtype[i] = types.TRANSPARENT
            ni[i] = r.Ni
        elif any(c > 0.0 for c in r.Ka):
            mtype[i] = types.LIGHT
            ka[i] = r.Ka
        elif r.Ns != 1.0:
            mtype[i] = types.GLOSSY
            ks[i] = r.Ks
            kd[i] = r.Kd
            ns[i] = r.Ns
        else:
            mtype[i] = types.DIFFUSE
            kd[i] = r.Kd
    return mtype, kd, ks, ka, ns, ni


def load_object(directory: str, objname: str) -> LoadedObject:
    """Load ``directory/objname`` (+ its mtllib) into SoA numpy arrays:
    fan-triangulated faces and per-face material indices (-1 where no
    ``usemtl`` is active, as tinyobj emits)."""
    obj_path = os.path.join(directory, objname)
    positions: list[tuple[float, float, float]] = []
    tri_idx: list[tuple[int, int, int]] = []
    tri_mat: list[int] = []
    raw_mats: list[RawMaterial] = []
    mat_index: dict[str, int] = {}
    cur_mat = -1

    def resolve_vidx(s: str) -> int:
        # face vertex "v", "v/vt", "v//vn", "v/vt/vn"; 1-based, negatives relative
        i = int(s.split("/")[0])
        return i - 1 if i > 0 else len(positions) + i

    with open(obj_path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "v":
                positions.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif key == "f":
                vids = [resolve_vidx(s) for s in tok[1:]]
                for k in range(1, len(vids) - 1):  # fan triangulation
                    tri_idx.append((vids[0], vids[k], vids[k + 1]))
                    tri_mat.append(cur_mat)
            elif key == "usemtl":
                name = tok[1] if len(tok) > 1 else ""
                cur_mat = mat_index.get(name, -1)
            elif key == "mtllib":
                for mtl in tok[1:]:
                    mtl_path = os.path.join(directory, mtl)
                    if os.path.exists(mtl_path):
                        for rm in parse_mtl(mtl_path):
                            mat_index[rm.name] = len(raw_mats)
                            raw_mats.append(rm)

    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    idx = np.asarray(tri_idx, np.int64).reshape(-1, 3)
    verts = pos[idx]  # (N, 3, 3)
    mtype, kd, ks, ka, ns, ni = classify_materials(raw_mats)
    return LoadedObject(
        verts=verts, mat_id=np.asarray(tri_mat, np.int32), mtype=mtype,
        kd=kd, ks=ks, ka=ka, ns=ns, ni=ni,
        mat_names=[r.name for r in raw_mats],
    )
