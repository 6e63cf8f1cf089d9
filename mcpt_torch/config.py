"""Config system — same JSON schema as the reference renderer.

The port's copy of ``mcpt/config.py`` (pure Python, so the logic carries over
unchanged; ``mcpt_torch`` never imports ``mcpt``).

The reference parses a single ``config.json`` with a top-level ``"config"`` array and a
``"configid"`` selector, and reads per-entry keys ``bvhtype``, ``testall``, ``testbvh``,
``camera``, ``directory``, ``objname``, ``width``, ``height``, ``platform``,
``raygenerator``, ``opencl``, ``intersect``, ``shade``, ``maxdepth``, ``attempt``
(reference ``config.cpp:70-125``, accessors ``config.cpp:128-145``).  Missing keys fall
back to zero-values (``config.cpp:37-66`` ``tryRead``) and ``bvhtype`` defaults to
``"hlbvh"`` (``config.cpp:86-89``).  The checked-in reference ``config.json`` contains
``#`` comments which strict JSON rejects (``config.json:90-101``); we strip them before
parsing so the shipped file loads as-is.

TPU-era extensions (all optional, zero-value defaults keep reference semantics):

- ``integrator``: ``{"nee": bool, "mis": bool, "russian_roulette": bool,
  "rr_start_depth": int}`` — physics upgrades the reference lacks.
- ``intersector``: ``"auto" | "bvh" | "brute"`` — brute-force is faster below a few
  hundred triangles.
- ``seed``: base RNG seed for the counter-based (threefry) sampler.
- ``mesh``: ``{"samples": int, "pixels": int}`` device-mesh shape for sharded
  rendering (see ``mcpt.dist``).
- ``output``: output image path stem (defaults to ``objname`` minus extension, like
  the reference's ``<objname>.hdr`` dump, ``colorout.cpp:66``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any

_COMMENT_RE = re.compile(r'^(?P<prefix>(?:[^"#]|"(?:[^"\\]|\\.)*")*)#.*$')


def strip_json_comments(text: str) -> str:
    """Remove ``#``-to-end-of-line comments outside of string literals."""
    out = []
    for line in text.splitlines():
        m = _COMMENT_RE.match(line)
        out.append(m.group("prefix") if m else line)
    return "\n".join(out)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera block (reference ``auxiliary.cpp:20-71`` ``parseCamera``)."""

    position: tuple[float, float, float] = (0.0, 0.0, 0.0)
    lookat: tuple[float, float, float] = (0.0, 0.0, -1.0)
    up: tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov: float = 0.0  # degrees, vertical (perspective camera)
    resolution: tuple[int, int] = (0, 0)
    # orthographic camera (reference cameraType 1, ``rayGenerator.cl:23-27`` —
    # dead code there, ``auxiliary.cpp:22`` hardcodes type 0): > 0 selects ortho
    # with this FULL view height in scene units (the kernel's ±arg/2 span).
    ortho_height: float = 0.0

    @staticmethod
    def from_json(d: dict[str, Any] | None) -> "CameraConfig | None":
        if not d:
            return None
        return CameraConfig(
            position=tuple(float(x) for x in d.get("position", (0, 0, 0))),
            lookat=tuple(float(x) for x in d.get("lookat", (0, 0, -1))),
            up=tuple(float(x) for x in d.get("up", (0, 1, 0))),
            fov=float(d.get("fov", 0.0)),
            resolution=tuple(int(x) for x in d.get("resolution", (0, 0))),
            ortho_height=float(d.get("ortho_height", 0.0)),
        )


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    """Estimator switches.  All-off reproduces the reference's pure BSDF-sampling
    integrator (``shade.cl:113-197``: no NEE, no MIS, no Russian roulette)."""

    nee: bool = False
    mis: bool = False
    russian_roulette: bool = False
    rr_start_depth: int = 3
    # firefly clamp: per-contribution radiance cap, 0 = off (biased; production
    # noise control — megakernel engine only)
    clamp: float = 0.0

    @staticmethod
    def from_json(d: dict[str, Any] | None) -> "IntegratorConfig":
        d = d or {}
        return IntegratorConfig(
            nee=bool(d.get("nee", False)),
            mis=bool(d.get("mis", False)),
            russian_roulette=bool(d.get("russian_roulette", False)),
            rr_start_depth=int(d.get("rr_start_depth", 3)),
            clamp=float(d.get("clamp", 0.0)),
        )


@dataclasses.dataclass(frozen=True)
class Config:
    """One selected entry of the ``"config"`` array."""

    # --- reference keys (config.cpp:86-123) ---
    bvhtype: str = "hlbvh"  # "hlbvh" | "treelet" | "treeletGPU" (alias: "treelet_opt")
    testall: bool = False
    testbvh: bool = False
    directory: str = ""
    objname: str | tuple[str, ...] = ""
    width: int = 0
    height: int = 0
    platform: str = ""  # informational only (the reference filters for NVIDIA GPUs)
    maxdepth: int = 0
    attempt: int = 0  # total samples per pixel to accumulate
    camera: CameraConfig | None = None
    # kernel-source paths: accepted for schema parity, unused (stages are built in)
    raygenerator: str = ""
    intersect: str = ""
    shade: str = ""
    opencl: bool = False
    # --- TPU-era extensions ---
    integrator: IntegratorConfig = dataclasses.field(default_factory=IntegratorConfig)
    intersector: str = "auto"
    # engine: "auto" picks the fused Pallas megakernel for VMEM-sized scenes,
    # the wavefront pipeline otherwise; "mega"/"wavefront" force one.
    engine: str = "auto"
    seed: int = 0
    spp_per_step: int = 1
    mesh: dict[str, int] = dataclasses.field(default_factory=dict)
    output: str = ""

    @property
    def objnames(self) -> tuple[str, ...]:
        """objname may be a single string or a list (testall mode, config.json:196+)."""
        if isinstance(self.objname, str):
            return (self.objname,) if self.objname else ()
        return tuple(self.objname)

    @property
    def output_stem(self) -> str:
        if self.output:
            return self.output
        name = self.objname if isinstance(self.objname, str) else ""
        return os.path.splitext(os.path.basename(name))[0]

    @staticmethod
    def from_entry(e: dict[str, Any]) -> "Config":
        objname = e.get("objname", "")
        if isinstance(objname, list):
            objname = tuple(str(x) for x in objname)
        return Config(
            bvhtype=str(e.get("bvhtype", "hlbvh") or "hlbvh"),
            testall=bool(e.get("testall", False)),
            testbvh=bool(e.get("testbvh", False)),
            directory=str(e.get("directory", "")),
            objname=objname,
            width=int(e.get("width", 0)),
            height=int(e.get("height", 0)),
            platform=str(e.get("platform", "")),
            maxdepth=int(e.get("maxdepth", 0)),
            attempt=int(e.get("attempt", 0)),
            camera=CameraConfig.from_json(e.get("camera")),
            raygenerator=str(e.get("raygenerator", "")),
            intersect=str(e.get("intersect", "")),
            shade=str(e.get("shade", "")),
            opencl=bool(e.get("opencl", False)),
            integrator=IntegratorConfig.from_json(e.get("integrator")),
            intersector=str(e.get("intersector", "auto")),
            engine=str(e.get("engine", "auto")),
            seed=int(e.get("seed", 0)),
            spp_per_step=int(e.get("spp_per_step", 1)),
            mesh=dict(e.get("mesh", {})),
            output=str(e.get("output", "")),
        )


def parse_config_text(text: str, configid: int | None = None) -> Config:
    doc = json.loads(strip_json_comments(text))
    entries = doc.get("config", [])
    if not entries:
        raise ValueError("config.json has no 'config' array")
    cid = doc.get("configid", 0) if configid is None else configid
    if not 0 <= int(cid) < len(entries):
        raise ValueError(f"configid {cid} out of range [0, {len(entries)})")
    return Config.from_entry(entries[int(cid)])


def load_config(path: str, configid: int | None = None) -> Config:
    """Load + select one config entry, reference ``config.cpp:70-84`` semantics."""
    with open(path, "r", encoding="utf-8") as f:
        return parse_config_text(f.read(), configid)
