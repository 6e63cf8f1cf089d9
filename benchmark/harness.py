"""One run of one cell: set-up, warm-up, the measured window, the traced
steps, the comparison with the plain reference, and the result line.

A cell is found by its name in ``BENCHMARK.json``: its configuration file
(the scene generator in ``scenes/<scene>.py`` and the render settings), its
traffic (``traffic/<name>.json``: the engine, the samples a step, the
warm-up and traced steps), the engine adapter (``engines/<engine>.py``),
its limits (``limits/<workload>.json``) and one reader a per-layer metric
(``layer_metrics/<metric>.py``).  Adding any of them is adding files and
entries; this module names none.

The loop is ``render_cli``'s, closed, with one client and one step in
flight: render a step, accumulate it into the framebuffer, read back its
segment count (the host waits for the step there).  It runs until the
window's seconds are spent; every step of the window counts.  The rates
take the window's host-clock seconds; each step's time is the period
between timing events the loop records on the card's stream at each
step's start, read on the card's clock (a host-clock reading is off by
about half a millisecond, more than a small step lasts).

A cell on N > 1 cards runs as N ranks, one a card (``ranks.py``): every
rank runs the same set-up and loop over the configuration's ``mesh``, rank
0's clock ends the window, and rank 0 alone times, traces, judges and
reports.  A cell on one card spawns nothing and makes no group.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from benchmark import check, devtrace as trace

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mcpt")
M32 = 0xFFFFFFFF
SEED_STRIDE = 7919  # render_cli: step seed = seed + samples done · 7919


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_cell_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    """Everything ``BENCHMARK.json`` under ``root`` says of cell ``name``,
    with its files read and its modules loaded."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    bench = root / Path(__file__).resolve().parent.name
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (bench / "traffic" / f"{cell['traffic']}.json").read_text())
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise SystemExit(f"traffic {cell['traffic']!r}: the harness runs a "
                         "closed loop with one client")
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    shown = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in shown)]
    return SimpleNamespace(
        name=name, chips=cell["chips"], cfg=cfg, traffic=traffic,
        e2e=e2e, layer=layer,
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        scene=_module(bench / "scenes" / f"{cfg['scene']}.py"),
        engine=_module(bench / "engines" / f"{traffic['engine']}.py"),
        readers={m["name"]: _module(bench / "layer_metrics"
                                    / f"{m['name']}.py") for m in layer})


def step_seed(seed: int, spp: int, i: int) -> int:
    """Step i's seed, as ``render_cli`` seeds its steps."""
    return (seed + i * spp * SEED_STRIDE) & M32


def sample_pixels(seed: int, n_pixels: int, k: int) -> np.ndarray:
    """The pixels the comparison reads, drawn from the run's seed."""
    rng = np.random.default_rng([seed & M32, seed >> 32, 0x5EED])
    return np.sort(rng.choice(n_pixels, size=min(k, n_pixels),
                              replace=False))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cell, device, wrap_step=None, mesh=None) -> SimpleNamespace:
    """The program's set-up for the cell: the benchmark's scene, then the
    engine adapter's build (scene build, pilot) → (scene, step, spans).
    ``wrap_step`` (tests) replaces the step function by
    ``wrap_step(step)``; a ``mesh`` (a cell on several ranks) goes to the
    adapter's build."""
    spans: dict = {}

    @contextlib.contextmanager
    def span(name):
        _sync(device)
        t0 = time.perf_counter()
        yield
        _sync(device)
        spans[name] = time.perf_counter() - t0

    scene = cell.scene.build()
    step = cell.engine.build(scene, cell.cfg, device, span,
                             **({} if mesh is None else dict(mesh=mesh)))
    if wrap_step is not None:
        step = wrap_step(step)
    return SimpleNamespace(scene=scene, step=step, spans=spans)


def warm_up(cell, prog, seed: int, device) -> None:
    """The window's shapes, on seeds of their own."""
    from mcpt_torch.render.integrator import accumulate
    from mcpt_torch.types import make_framebuffer

    spp = int(cell.traffic["spp_per_step"])
    fb = make_framebuffer(cell.cfg["width"] * cell.cfg["height"], device)
    for i in range(cell.traffic["warmup_steps"]):
        radiance, segs = prog.step(step_seed(seed ^ 0xA5A5A5A5, spp, i), spp)
        fb = accumulate(fb, radiance, spp=spp)
        float(segs)
    _sync(device)


def window(cell, prog, seed: int, seconds: float, traced: bool,
           device, agree=None) -> SimpleNamespace:
    """The measured window: steps until ``seconds`` have passed, each
    rendered, accumulated into a fresh framebuffer and read back; with
    ``traced`` the first ``trace_steps`` under the profiler.  On several
    ranks ``agree(stop)`` turns rank 0's decision to stop after a step into
    every rank's (``step.agree``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mcpt_torch.render.integrator import accumulate
    from mcpt_torch.types import make_framebuffer

    spp = int(cell.traffic["spp_per_step"])
    fb = make_framebuffer(cell.cfg["width"] * cell.cfg["height"], device)
    _sync(device)
    rf = record_function if traced else (lambda _: contextlib.nullcontext())
    n_trace = int(cell.traffic["trace_steps"]) if traced else 0
    prof = None
    if n_trace:
        # the profiler's start and stop stay outside the window's clock
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    times, seg_counts, seeds, marks = [], [], [], []
    agree_s = 0.0
    t_win = time.perf_counter()
    while True:
        i = len(times)
        s = step_seed(seed, spp, i)
        marks.append(_mark(device))
        t0 = time.perf_counter()
        with rf("step.render"):
            radiance, segs = prog.step(s, spp)
        with rf("step.accumulate"):
            fb = accumulate(fb, radiance, spp=spp)
        with rf("step.readback"):
            n_segs = float(segs)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        seg_counts.append(n_segs)
        seeds.append(s)
        if prof is not None and i + 1 == n_trace:
            _stop(prof, device)
            t_win += time.perf_counter() - t1
            t1 = time.perf_counter()
        stop = t1 - t_win >= seconds
        if agree is not None:
            t_a = time.perf_counter()
            with rf("step.agree"):
                stop = agree(stop)
            agree_s += time.perf_counter() - t_a
        if stop:
            break
    marks.append(_mark(device))
    if prof is not None and len(times) < n_trace:
        _stop(prof, device)
    _sync(device)
    if marks[0] is not None:
        # each step's period on the card's clock: from its start mark to
        # the next step's, which the card reaches once the host has read
        # the segments back and launched again (its queue is empty there)
        times = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    return SimpleNamespace(fb=fb, times=times, seg_counts=seg_counts,
                           seeds=seeds, prof=prof, n_trace=n_trace,
                           t_win=t_win, window_s=t1 - t_win, spp=spp,
                           agree_s=agree_s)


def _mark(device):
    """A timing event recorded on the card's stream (None off the card)."""
    if device.type != "cuda":
        return None
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _stop(prof, device) -> None:
    import warnings

    _sync(device)
    with warnings.catch_warnings():
        # one profiling cycle: its "clears events" notice does not apply
        warnings.simplefilter("ignore", UserWarning)
        prof.stop()


def framebuffer_at(fb, pixels, device) -> tuple:
    """(radiance sums (K, 3) float64, sample counts (K,)) on the host."""
    import torch

    pix = torch.as_tensor(pixels, device=device)
    return (fb.sum[pix].double().cpu().numpy(),
            fb.count[pix].cpu().numpy())


def checked_step(seed: int, n_steps: int) -> int:
    """The step whose segments a ``full_step`` cell compares, drawn from
    the run's seed."""
    rng = np.random.default_rng([seed & M32, seed >> 32, 0x57E9])
    return int(rng.integers(n_steps))


def judge(cell, scene, seed: int, win, prog_rad, prog_count,
          device) -> tuple:
    """The plain reference over the window's samples at the pixels drawn
    from ``seed`` (and, for a ``full_step`` cell, over every pixel of one
    step) → (the compared numbers, the sampled pixels' segments a path
    against the program's over the image: an estimate, not compared)."""
    from benchmark.reference import render as reference

    n_pixels = cell.cfg["width"] * cell.cfg["height"]
    n_samples = len(win.times) * win.spp
    pixels = sample_pixels(seed, n_pixels, int(cell.limits["pixels"]))
    ref, hits = reference.prepare(scene, cell.cfg, device)
    ref_rad, ref_segs = reference.render_pixels(ref, hits, pixels,
                                                win.seeds, win.spp)
    step_segs = None
    if cell.limits.get("full_step"):
        j = checked_step(seed, len(win.times))
        _, all_segs = reference.render_pixels(
            ref, hits, np.arange(n_pixels), [win.seeds[j]], win.spp)
        step_segs = (win.seg_counts[j], float(all_segs.sum()))
    est = (sum(win.seg_counts) / n_pixels) / (float(ref_segs.sum())
                                              / len(pixels)) - 1.0
    return check.compare(prog_rad, prog_count, ref_rad, n_samples,
                         step_segs), est


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, wrap_step=None, world=None) -> tuple:
    """One run → (result dict, stderr lines); with ``world``
    (``ranks.World``) as rank 0 of a cell on several ranks."""
    import torch

    mesh = None if world is None else world.mesh
    t_build = time.perf_counter()
    prog = build(cell, device, wrap_step, mesh)
    t_warm = time.perf_counter()
    warm_up(cell, prog, seed, device)
    win = window(cell, prog, seed, seconds, traced, device,
                 None if world is None else world.agree)
    setup_s = win.t_win - t_start
    n_steps, spp, times = len(win.times), win.spp, win.times
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n_pixels = cell.cfg["width"] * cell.cfg["height"]
    pixels = sample_pixels(seed, n_pixels, int(cell.limits["pixels"]))
    prog_rad, prog_count = framebuffer_at(win.fb, pixels, device)
    # the reference runs once the program's state is freed
    scene, spans = prog.scene, prog.spans
    del prog
    win.fb = None
    gc.collect()
    if world is not None:
        # the other ranks free their state and exit before the reference
        peak = max([peak, *world.finish()])
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    values, segs_est = judge(cell, scene, seed, win, prog_rad, prog_count,
                             device)
    t_ref = time.perf_counter() - t_ref
    correct = check.verdict(values, cell.limits)
    seg_counts, window_s = win.seg_counts, win.window_s

    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=cell.chips, memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct), attempted=n_steps,
                  failed=0 if correct else n_steps)
    if traced:
        tr = trace.from_profile(win.prof)
        segs = sum(seg_counts[:win.n_trace])
        # rank 0's card traces its share of the mesh's segments: the ranks
        # split every pixel's samples evenly (equal up to sampling noise)
        ctx = SimpleNamespace(trace=tr, steps=min(win.n_trace, n_steps),
                              segs=segs, card_segs=segs / (
                                  1 if world is None else world.size),
                              spans=spans)
        metrics = {}
        for m in cell.layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        lo, hi = trace.window(tr)
        dev.update(busy_s=trace.busy_us(tr) / 1e6, window_s=(hi - lo) / 1e6)
        ops = sorted(trace.by_name(tr).items(), key=lambda kv: -kv[1])
        gaps: dict = {}
        for label, us in trace.idle_gaps(tr):
            gaps[label] = gaps.get(label, 0.0) + us
        breakdown = dict(
            device_ops=[[n[:160], us / 1e6] for n, us in ops[:10]],
            idle_gaps=[[n, us / 1e6] for n, us in
                       sorted(gaps.items(), key=lambda kv: -kv[1])[:10]])
    else:
        stats = end_to_end(times, seg_counts, spp, window_s, setup_s)
        metrics = {m["name"]: dict(value=stats[m["name"]], unit=m["unit"])
                   for m in cell.e2e}
        breakdown = None
    result.update(metrics=metrics, device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["card"] = _card(device)
    # JSON has no infinity: a reading that is not finite prints as 1e308
    result["check"] = {k: dict(value=min(values[k], 1e308),
                               limit=cell.limits[k])
                       for k in check.compared(cell.limits)}
    on_ranks = ("" if world is None else
                f"{world.describe()}, agreement "
                f"{win.agree_s / max(n_steps, 1) * 1e3:.4f} ms a step; ")
    fifths = "/".join(f"{np.median(q) * 1e3:.3f}"
                      for q in np.array_split(times, 5) if len(q))
    info = [f"run {cell.name} seed {seed}: {on_ranks}{n_steps} steps in "
            f"{window_s:.3f} s, set-up {setup_s:.3f} s (start to build "
            f"{t_build - t_start:.3f} s, build {t_warm - t_build:.3f} s, "
            f"warm-up {win.t_win - t_warm:.3f} s; "
            f"{', '.join(f'{k} {v:.3f} s' for k, v in spans.items())}), "
            f"step ms median {np.median(times) * 1e3:.3f} (by fifths of "
            f"the window {fifths}) p95 "
            f"{np.percentile(times, 95) * 1e3:.3f} max "
            f"{max(times) * 1e3:.3f}, reference {t_ref:.3f} s over "
            f"{len(pixels)} pixels (largest gap {values['pixel_gap_max']!r}), "
            f"segments {sum(seg_counts):.0f} (a path "
            f"over the image against the sampled pixels' {segs_est:+.5f})"]
    return result, info + check.lines(values, cell.limits)


def run_ranks(cell, seed: int, seconds: float, traced: bool,
              device_type: str, t_start: float, root: Path = ROOT,
              wrap_step=None) -> tuple:
    """One run of a cell on ``cell.chips`` ranks, this process rank 0 →
    (result dict, stderr lines)."""
    from benchmark import ranks

    world = ranks.start(cell, [seed], seconds, device_type, root)
    try:
        return run_cell(cell, seed, seconds, traced, world.device, t_start,
                        wrap_step, world)
    finally:
        world.close()


def end_to_end(times, seg_counts, spp: int, window_s: float,
               setup_s: float) -> dict:
    """The window's rates over all its steps and all its seconds, the 95th
    percentile of every step's time, and the set-up."""
    return dict(spp_per_s=len(times) * spp / window_s,
                mrays_per_s=sum(seg_counts) / window_s / 1e6,
                step_ms_p95=float(np.percentile(times, 95)) * 1e3,
                setup_s=setup_s)


def _card(device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level names."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no CUDA device for {args.workload}: it needs {cell.chips} "
              f"card(s), torch sees {seen}", file=sys.stderr)
        return 2
    if cell.chips > 1:
        result, lines = run_ranks(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda", t_start)
    else:
        result, lines = run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda", 0),
                                 t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in result["metrics"].items():
        if not math.isfinite(v["value"]):
            print(f"metric {k} is not finite", file=sys.stderr)
            return 4
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0
