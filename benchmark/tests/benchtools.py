"""Helpers of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout with a tiny cell of its own."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CFG = {
    "name": "tiny", "scene": "cornell_box", "width": 12, "height": 10,
    "maxdepth": 16, "bvhtype": "hlbvh", "t_min": 0.0001,
    "integrator": {"nee": True, "mis": True, "russian_roulette": True,
                   "rr_start_depth": 3, "clamp": 0.0},
    "reduced": [], "check_pixels": 40,
}


def tiny_checkout(tmp: Path, engine: str = "mega", spp: int = 2,
                  cfg: dict | None = None) -> Path:
    """A checkout holding the real scenes, engines and per-layer readers,
    and one cell ``tiny-<engine>`` of its own (12×10)."""
    bench = tmp / "benchmark"
    for sub in ("scenes", "engines", "layer_metrics", "limits"):
        shutil.copytree(ROOT / "benchmark" / sub, bench / sub)
    (bench / "configs").mkdir()
    (bench / "traffic").mkdir()
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg or TINY_CFG))
    (bench / "traffic" / f"{engine}-tiny.json").write_text(json.dumps(dict(
        engine=engine, loop="closed", clients=1, spp_per_step=spp,
        warmup_steps=1, trace_steps=2)))
    name = f"tiny-{engine}"
    (bench / "limits" / f"{name}.json").write_text(json.dumps(
        json.loads((ROOT / "benchmark" / "limits"
                    / "cbox-mega-step16.json").read_text())))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [dict(name="tiny", source="test",
                            file="benchmark/configs/tiny.json", reduced=[],
                            why="test")]
    spec["workloads"] = [dict(name=name, config="tiny",
                              traffic=f"{engine}-tiny", chips=1, why="test")]
    for m in spec["end_to_end"]:
        if "workloads" in m:  # the tiny cell reports what one card's do
            m["workloads"] = [name]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
