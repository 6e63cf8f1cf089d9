"""The port's spans (``mcpt_torch.trace``) on the CPU: off, a span is one
check and a shared no-op; under ``torch.profiler`` it is a host range of
the function scope (no echo on the device timeline) and the engines give
the same bits with and without it; the hybrid's stages, the host waits and
the wavefront's parts are the spans the profile reports; ``render_cli
--profile`` prints them.  The CUDA-only spans (kernels 1 and 3's launches,
the overflow flags) are held on the card in ``test_torch_cuda.py``."""

import collections
import dataclasses
import os
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mcpt_torch import render_cli, rng
from mcpt_torch import scenes as tscenes
from mcpt_torch import trace
from mcpt_torch.bvh.lbvh import one_thread
from mcpt_torch.kernels import cluster_megakernel as cmk
from mcpt_torch.kernels import megakernel as mk
from mcpt_torch.render import integrator as integ
from mcpt_torch.render.camera import make_camera
from mcpt_torch.scene import build_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def boxfield60():
    loaded, camcfg = tscenes.boxfield(60)
    scene, lights = build_scene(loaded, device="cpu")
    cam = make_camera(dataclasses.replace(camcfg, resolution=(16, 12)),
                      device="cpu")
    return scene, lights, cam


def _profiled(fn):
    """fn() under a CPU profiler → (its result, Counter of its mcpt. span
    names, the profile's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = prof.events()
    return out, collections.Counter(e.name for e in events
                                    if e.name.startswith("mcpt.")), events


def test_span_is_off_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(trace, "_range", lambda name: calls.append(name))
    assert not torch._C._autograd._profiler_enabled()
    first = trace.span("mcpt.a")
    for _ in range(1000):
        with trace.span("mcpt.b"):
            pass
    assert calls == [] and trace.span("mcpt.c") is first


def test_span_records_a_function_scope_range_under_the_profiler():
    """A host range named as given, in the function scope: it leaves no
    echo on the device timeline, as a user-scope ``record_function``
    would, and the ops launched inside it are its children."""
    def work():
        with trace.span("mcpt.test.outer"):
            with trace.span("mcpt.test.inner"):
                return torch.ones(8) + 1.0

    out, counts, events = _profiled(work)
    assert torch.equal(out, torch.full((8,), 2.0))
    assert counts == {"mcpt.test.outer": 1, "mcpt.test.inner": 1}
    spans = {e.name: e for e in events if e.name.startswith("mcpt.")}
    assert all(not e.is_user_annotation and e.device_type == DeviceType.CPU
               for e in spans.values())
    assert spans["mcpt.test.inner"].cpu_parent is spans["mcpt.test.outer"]
    assert any(e.cpu_parent is spans["mcpt.test.inner"] for e in events
               if e.name == "aten::add")


def test_count_records_nothing_outside_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(trace, "_range", lambda name: calls.append(name))
    assert not torch._C._autograd._profiler_enabled()
    for n in range(1000):
        trace.count("k2_lanes", n)
    assert calls == []


def test_hybrid_counts_k2_lanes_a_bounce(boxfield60):
    """Under the profiler a CPU hybrid render leaves one
    ``mcpt.count.k2_lanes`` value a bounce, inside the bounce's span, each
    the rows of that bounce's pool × 128: 64 rows, then 32 under the caps
    (4,608 lanes a sample pass of 16×12 at 24 spp)."""
    scene, lights, cam = boxfield60
    cms = cmk.build_cluster_megascene(scene, lights)
    (_, _), counts, events = _profiled(lambda: cmk._run_hybrid(
        cms, cam, 16, 12, 24, 5, max_depth=4, rr=True, rr_start=1,
        compact=(0.3, 0.2)))
    rows = cmk._compaction_schedule(-(-16 * 12 * 24 // cmk.BLKT)
                                    * cmk.SUBT, 4, (0.3, 0.2))
    assert rows == [64, 32, 32, 32]
    values = [trace.counted(e.name) for e in events
              if trace.counted(e.name)]
    assert values == [("mcpt.count.k2_lanes", r * 128) for r in rows]
    assert sum(v for _, v in values) == sum(rows) * 128
    assert all(e.cpu_parent.name == "mcpt.hybrid.bounce" for e in events
               if trace.counted(e.name))
    assert counts["mcpt.hybrid.bounce"] == 4


def test_spanned_keeps_the_function():
    assert rng.uniform.__name__ == "uniform"
    a = rng.uniform(rng.key(3), (5,), "cpu")
    b, counts, _ = _profiled(lambda: rng.uniform(rng.key(3), (5,), "cpu"))
    assert torch.equal(a, b) and counts == {"mcpt.rng.uniform": 1}


def _engine(name, boxfield60):
    kw = dict(spp=2, seed=5, max_depth=3, nee=True, mis=True, rr=True,
              rr_start=1)
    if name == "mega":
        loaded, camcfg = tscenes.cornell_box()
        scene, lights = build_scene(loaded, device="cpu")
        cam = make_camera(dataclasses.replace(camcfg, resolution=(12, 8)),
                          device="cpu")
        mega = mk.build_megascene(scene, lights)
        return lambda: mk.render_mega(mega, cam, 12, 8, **kw)
    scene, lights, cam = boxfield60
    cms = cmk.build_cluster_megascene(scene, lights)
    if name == "cluster_mega":
        return lambda: cmk.render_cluster_mega(cms, cam, 16, 12, **kw)
    return lambda: cmk.render_hybrid(cms, cam, 16, 12, compact=(0.3, 0.2),
                                     **kw)


@pytest.mark.parametrize("name", ["mega", "cluster_mega", "hybrid"])
def test_engines_give_the_same_bits_under_the_profiler(boxfield60, name):
    render = _engine(name, boxfield60)
    a, sa = render()
    (b, sb), counts, _ = _profiled(render)
    assert torch.equal(a, b) and float(sa) == float(sb)
    if name == "hybrid":
        # one raygen (with its camera-table wait), a bounce a depth, a sort
        # a depth but the last, a roulette a shrinking pool, one reduce,
        # and a bounce's lanes counted a bounce
        rows = cmk._compaction_schedule(-(-16 * 12 * 2 // cmk.BLKT)
                                        * cmk.SUBT, 3, (0.3, 0.2))
        shrinks = sum(b < a for a, b in zip(rows, rows[1:]))
        assert counts == collections.Counter({
            "mcpt.hybrid.raygen": 1, "mcpt.wait.sf": 1,
            "mcpt.hybrid.bounce": 3, "mcpt.hybrid.sort": 2,
            "mcpt.hybrid.roulette": shrinks, "mcpt.hybrid.reduce": 1,
            **collections.Counter(f"mcpt.count.k2_lanes={r * 128}"
                                  for r in rows)})
    else:
        # the plain versions on the CPU record no span
        assert counts == {}


def test_wavefront_parts_are_spans(boxfield60):
    """The wavefront through the cluster walk with the resort on: each of
    its parts is a span, its draws nested in them."""
    scene, lights, cam = boxfield60
    opts = integ.RenderOptions(max_depth=2, nee=True, mis=True,
                               method="cluster", resort=True)
    (a, _), counts, events = _profiled(lambda: integ.render_batch(
        scene, lights, cam, 16, 12, rng.key(1), opts, spp=2,
        with_stats=True))
    b, _ = integ.render_batch(scene, lights, cam, 16, 12, rng.key(1), opts,
                              spp=2, with_stats=True)
    assert torch.equal(a, b)
    assert counts == {
        "mcpt.wavefront.camera": 2, "mcpt.rng.uniform": 2 + 2 * 2,
        "mcpt.wavefront.closest_hit": 2, "mcpt.wavefront.any_hit": 2,
        "mcpt.wavefront.shade": 2, "mcpt.wavefront.nee": 2,
        "mcpt.wavefront.resort": 2, "mcpt.wavefront.resort_keys": 2}
    nee = [e for e in events if e.name == "mcpt.wavefront.nee"]
    assert all(any(c.name == "mcpt.wavefront.any_hit"
                   for c in e.cpu_children) for e in nee)


def _event(name, start, end, device=False, dev_us=0.0, user=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        device_time_total=dev_us, is_user_annotation=user)


def test_report_puts_idle_down_to_the_innermost_span():
    """Two steps on a 0-100 µs host extent: the card runs 10-30, 50-52 and
    60-90; its idle gaps fall outside any span (0-10), in a wait nested in
    a bounce (30-50), in a sort (52-60) and in a reduce (90-100).  A
    user-scope range's echo (20-95) is not device work."""
    events = [
        _event("aten::empty", 0, 2),
        _event("mcpt.hybrid.bounce", 6, 52, dev_us=20.0),
        _event("mcpt.wait.k2_flag", 29, 51, dev_us=2.0),
        _event("mcpt.hybrid.sort", 52, 62, dev_us=30.0),
        _event("mcpt.hybrid.reduce", 88, 100),
        _event("mcpt::fused_bounce_kernel", 10, 30, device=True),
        _event("Memcpy DtoH (Device -> Pinned)", 50, 52, device=True),
        _event("sort", 60, 90, device=True),
        _event("step.render", 20, 95, device=True, user=True),
    ]
    text = trace.report(SimpleNamespace(events=lambda: events), steps=2)
    rows = {line.split()[0]: [float(x) for x in line.split()[1:]]
            for line in text.splitlines() if line.startswith("mcpt.")}
    assert rows["mcpt.hybrid.bounce"] == [0.5, 0.023, 0.01, 0.0]
    assert rows["mcpt.wait.k2_flag"] == [0.5, 0.011, 0.001, 0.01]
    assert rows["mcpt.hybrid.sort"] == [0.5, 0.005, 0.015, 0.004]
    assert rows["mcpt.hybrid.reduce"] == [0.5, 0.006, 0.0, 0.005]
    assert "card busy 52.0% of 0.100 ms" in text
    assert "idle outside mcpt spans 0.005 ms a step" in text


def test_report_sums_a_counter_in_one_row():
    """Two steps with the counter's empty ranges in their bounces: one row
    with its calls and the sum of its values a step, no span row of its
    own, and the bounce's idle as it was."""
    events = [
        _event("aten::empty", 0, 2),
        _event("mcpt.hybrid.bounce", 6, 52, dev_us=20.0),
        _event("mcpt.count.k2_lanes=3686400", 7, 7),
        _event("mcpt.count.k2_lanes=1572864", 40, 40),
        _event("mcpt::fused_bounce_kernel", 10, 30, device=True),
        _event("sort", 60, 100, device=True),
    ]
    def rows_of(evs):
        text = trace.report(SimpleNamespace(events=lambda: evs), steps=2)
        return text, {line.split()[0]: line.split()[1:]
                      for line in text.splitlines()
                      if line.startswith("mcpt.")}

    text, rows = rows_of(events)
    assert rows["mcpt.count.k2_lanes"] == ["1.00", "value/step",
                                           "2629632.0"]
    # the card idles 30-52 inside the bounce: 0.011 ms a step
    assert rows["mcpt.hybrid.bounce"] == ["0.50", "0.023", "0.010",
                                          "0.011"]
    assert set(rows) == {"mcpt.hybrid.bounce", "mcpt.count.k2_lanes"}
    assert "1 mcpt spans" in text
    uncounted = [e for e in events if not trace.counted(e.name)]
    assert rows_of(uncounted)[1] == {"mcpt.hybrid.bounce":
                                     rows["mcpt.hybrid.bounce"]}


def test_cli_profile_prints_the_spans(tmp_path, capsys):
    """Config 2 at 16×16, 4 steps of 1 spp: the first runs unprofiled, the
    other three under the profiler, whose mcpt. spans are printed."""
    assert render_cli.main(["--config", os.path.join(ROOT, "config.json"),
                            "--configid", "2", "--width", "16", "--height",
                            "16", "--spp", "4", "--device", "cpu", "--out",
                            str(tmp_path), "--profile"]) == 0
    text = capsys.readouterr().out
    assert "profile: 3 steps under torch.profiler, 6 mcpt spans" in text
    rows = [line.split() for line in text.splitlines()
            if line.startswith("mcpt.")]
    assert {r[0] for r in rows} == {"mcpt.accumulate", "mcpt.wait.segments"}
    assert all(r[1] == "1.00" for r in rows)
    assert "card busy" not in text  # no card in the trace
