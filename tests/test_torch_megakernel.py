"""The port's megakernel module against ``mcpt``'s Pallas megakernel.

``render_mega_reference`` (the plain PyTorch version the CUDA kernel is held
against on the card) is compared pixel by pixel with
``mcpt.pallas.megakernel.render_mega(..., interpret=True)`` on the same
seeds: the counter-hash RNG gives both the same random streams.

The JAX side runs in a child process with ``--xla_cpu_max_isa=AVX``: without
FMA instructions XLA rounds every multiply and add separately, as PyTorch's
elementwise ops do (and as the CUDA kernel, built with -fmad=false, does);
LLVM optimisation level 0 only shortens the interpreter's compile.
What is left are ulp-level differences of XLA's sin/cos/exp/log/sqrt, which
move a path only where two triangles tie exactly: cbox's glass box stands on
the floor, so a ray inside it meets two coplanar triangles at the same t,
and the last bit of t picks glass or floor.  How many pixels that flips
depends on the seed, so the cbox comparisons raise the glass box off the
floor (``GLASS_BOX_LIFT``): the transparent branch stays, the tie goes, and
the gate (≥ 99% of pixels within |a-b| ≤ 1e-4·|b| + 1e-5, image means
within 1e-3, segments within 0.1%) holds on any seed.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# cbox's glass short box is its last 12 triangles; 1 unit (of a 559-unit
# room) above the floor its bottom no longer ties with the floor
GLASS_BOX_LIFT = {"n_tris": 12, "dy": 1.0}

_JAX_RENDER = r"""
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from mcpt import scenes
from mcpt.pallas import megakernel as mk
from mcpt.render import camera as cm
from mcpt.scene import build_scene
a = json.loads(sys.argv[1])
loaded, camcfg = getattr(scenes, a["scene"])(**a["scene_kw"])
if a["lift"]:
    verts = loaded.verts.copy()
    verts[-a["lift"]["n_tris"]:, :, 1] += a["lift"]["dy"]
    loaded = dataclasses.replace(loaded, verts=verts)
camcfg = dataclasses.replace(camcfg, resolution=(a["w"], a["h"]))
scene, lights = build_scene(loaded)
rad, segs = mk.render_mega(mk.build_megascene(scene, lights),
                           cm.make_camera(camcfg), a["w"], a["h"],
                           interpret=True, **a["kw"])
np.savez(a["out"], rad=np.asarray(rad), segs=float(segs))
"""


def jax_child(tmp_path, script, **args):
    """Run ``script`` (JAX code reading ``json.loads(sys.argv[1])`` and
    saving an .npz at ``args["out"]``) in a child process whose XLA emits no
    FMA; return the arrays it saved."""
    out = str(tmp_path / "jax_child.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
               "--xla_backend_optimization_level=0")
    proc = subprocess.run(
        [sys.executable, "-c", script, json.dumps(dict(args, out=out))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600,
        check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def jax_render_mega(tmp_path, scene, w, h, scene_kw=None, lift=None, **kw):
    """``mcpt``'s megakernel in the Pallas interpreter; ``lift`` raises the
    scene's last ``n_tris`` triangles by ``dy`` (see ``GLASS_BOX_LIFT``)."""
    z = jax_child(tmp_path, _JAX_RENDER, scene=scene, w=w, h=h, kw=kw,
                  scene_kw=scene_kw or {}, lift=lift)
    return z["rad"], float(z["segs"])


def torch_render_mega(scene, w, h, scene_kw=None, lift=None, **kw):
    import dataclasses

    from mcpt_torch import scenes
    from mcpt_torch.kernels import megakernel as mk
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.scene import build_scene

    loaded, camcfg = getattr(scenes, scene)(**(scene_kw or {}))
    if lift:
        verts = loaded.verts.copy()
        verts[-lift["n_tris"]:, :, 1] += lift["dy"]
        loaded = dataclasses.replace(loaded, verts=verts)
    camcfg = dataclasses.replace(camcfg, resolution=(w, h))
    sc, lights = build_scene(loaded, device="cpu")
    rad, segs = mk.render_mega_reference(mk.build_megascene(sc, lights),
                                         make_camera(camcfg, device="cpu"),
                                         w, h, **kw)
    return rad.numpy(), float(segs)


def assert_parity(a, b, segs_a, segs_b):
    """chip_smoke.py phase 3's gate: ≥ 99% of pixels within
    |a-b| ≤ 1e-4·|b| + 1e-5, image means within 1e-3, segments within 0.1%."""
    assert a.shape == b.shape and np.isfinite(a).all()
    share = (np.abs(a - b) <= 1e-4 * np.abs(b) + 1e-5).all(-1).mean()
    mean_rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    assert share >= 0.99, share
    assert mean_rel <= 1e-3, mean_rel
    assert abs(segs_a / segs_b - 1.0) <= 1e-3, (segs_a, segs_b)


def test_cbox_regen_nee_mis_rr_matches_mcpt(tmp_path):
    """Unrolled tier, path regeneration, NEE+MIS+RR: lanes die early (escape,
    light hits, roulette) and start their next sample in place.  The glass
    box is lifted (see the module docstring).  Measured on seeds 0-9 of this
    view: with the glass box on the floor, 2, 2, 4, 2, 0, 3, 1, 4, 1 and 2
    of the 256 pixels fall outside the pixel tolerance, and seeds 0, 2, 5, 7
    and 9 fail the gate (on the share, the mean or the segments); lifted,
    no pixel differs on any of them and the segments are equal."""
    kw = dict(spp=4, seed=4, max_depth=6, nee=True, mis=True, rr=True,
              rr_start=2, schedule="regen", lift=GLASS_BOX_LIFT)
    want, s_want = jax_render_mega(tmp_path, "cornell_box", 16, 16, **kw)
    got, s_got = torch_render_mega("cornell_box", 16, 16, **kw)
    assert_parity(got, want, s_got, s_want)


def test_regen_equals_batch_per_lane_exit():
    """Both schedules draw the same (sample, pixel) streams, and a lane stops
    at its own death in both: the plain version gives the same bits."""
    kw = dict(spp=3, seed=9, max_depth=6, nee=True, mis=True, rr=True,
              rr_start=1)
    r_regen, s_regen = torch_render_mega("cornell_box", 12, 10,
                                         schedule="regen", **kw)
    r_batch, s_batch = torch_render_mega("cornell_box", 12, 10,
                                         schedule="batch", **kw)
    np.testing.assert_allclose(r_regen, r_batch, rtol=1e-6, atol=1e-6)
    assert s_regen == s_batch


def test_plain_version_never_counts_launches():
    from mcpt_torch.kernels import megakernel as mk

    before = mk.LAUNCHES
    torch_render_mega("quad_light_plane", 4, 4, spp=1, seed=0)
    assert mk.LAUNCHES == before


def test_sample_base_offsets_the_stream():
    """A render of samples [2, 4) equals the second half of a 4-spp batch
    render with the same seed (global (sample, pixel) RNG counters)."""
    kw = dict(seed=3, max_depth=4, nee=True, mis=True, schedule="batch")
    full, _ = torch_render_mega("quad_light_plane", 6, 5, spp=4, **kw)
    first, _ = torch_render_mega("quad_light_plane", 6, 5, spp=2, **kw)
    second, _ = torch_render_mega("quad_light_plane", 6, 5, spp=2,
                                  sample_base=2, **kw)
    np.testing.assert_allclose(first + second, full, rtol=1e-6, atol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("scene,w,h,kw", [
    # a white short box: its floor-coplanar bottom then ties with the floor
    # without changing the material, so ulp-level ties cannot flip pixels
    ("cornell_box", 12, 12, dict(spp=2, seed=1, max_depth=8, nee=True,
                                 mis=True, rr=True, schedule="batch",
                                 scene_kw={"short_material": "white"})),
    ("veach_mis", 12, 8, dict(spp=2, seed=2, max_depth=8, nee=True,
                              schedule="batch")),
    ("furnace_sphere", 8, 8, dict(spp=2, seed=3, max_depth=6, nee=True,
                                  mis=True, schedule="regen")),
    ("quad_light_plane", 12, 12, dict(spp=3, seed=4, max_depth=6, nee=True,
                                      mis=True, rr=True, rr_start=1,
                                      clamp=1.0, schedule="regen")),
])
def test_more_combinations_match_mcpt(tmp_path, scene, w, h, kw):
    want, s_want = jax_render_mega(tmp_path, scene, w, h, **kw)
    got, s_got = torch_render_mega(scene, w, h, **kw)
    assert_parity(got, want, s_got, s_want)
