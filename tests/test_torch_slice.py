"""The port's small-scene render path as a whole: config → scene → camera →
megakernel → accumulate → image against ``mcpt``'s pipeline, the render CLI,
checkpoints that cross between the two CLIs, and the physics oracles (the
furnace identity and the golden gates) on the plain PyTorch version."""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from mcpt import types as jtypes
from mcpt_torch import render_cli
from mcpt_torch import scenes as tscenes
from mcpt_torch.config import load_config
from mcpt_torch.io import image as im
from mcpt_torch.kernels import megakernel as tmk
from mcpt_torch.render import camera as tcamera
from mcpt_torch.render import integrator as tinteg
from mcpt_torch.scene import build_scene
from mcpt_torch.types import make_framebuffer
from test_torch_megakernel import assert_parity, jax_child

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools.compare import compare  # noqa: E402

# config 2 (quad_light_plane, NEE+MIS, depth 6), 2 steps of 1 spp at 16x16,
# seeds cfg.seed + done·7919 as both CLIs schedule them
_PIPE = dict(configid=2, width=16, height=16, spp=2)

_JAX_PIPELINE = r"""
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from mcpt.config import load_config
from mcpt.pallas import megakernel as mk
from mcpt.render import camera as cm
from mcpt.render import integrator as integ
from mcpt.types import make_framebuffer
from tools.render import build_from_config
a = json.loads(sys.argv[1])
cfg = load_config("config.json", a["configid"])
scene, lights, cam_cfg = build_from_config(cfg)
w, h = a["width"], a["height"]
cam = cm.make_camera(dataclasses.replace(cam_cfg, resolution=(w, h)))
mega = mk.build_megascene(scene, lights)
fb, segs, done = make_framebuffer(w * h), 0.0, 0
while done < a["spp"]:
    rad, s = mk.render_mega(mega, cam, w, h, spp=1, seed=cfg.seed + done * 7919,
                            max_depth=cfg.maxdepth, rr=cfg.integrator.russian_roulette,
                            rr_start=cfg.integrator.rr_start_depth, nee=cfg.integrator.nee,
                            mis=cfg.integrator.mis, clamp=cfg.integrator.clamp,
                            interpret=True)
    fb = integ.accumulate(fb, rad, spp=1)
    segs += float(s)
    done += 1
np.savez(a["out"], img=integ.framebuffer_image(fb, w, h), segs=segs)
"""


def _torch_pipeline(configid, width, height, spp):
    cfg = load_config(os.path.join(ROOT, "config.json"), configid)
    scene, lights, cam_cfg = render_cli.build_from_config(cfg, "cpu")
    cam = tcamera.make_camera(
        dataclasses.replace(cam_cfg, resolution=(width, height)),
        device="cpu")
    mega = tmk.build_megascene(scene, lights)
    fb, segs = make_framebuffer(width * height, "cpu"), 0.0
    for done in range(spp):
        rad, s = tmk.render_mega(
            mega, cam, width, height, spp=1, seed=cfg.seed + done * 7919,
            max_depth=cfg.maxdepth, rr=cfg.integrator.russian_roulette,
            rr_start=cfg.integrator.rr_start_depth, nee=cfg.integrator.nee,
            mis=cfg.integrator.mis, clamp=cfg.integrator.clamp)
        fb = tinteg.accumulate(fb, rad, spp=1)
        segs += float(s)
    return tinteg.framebuffer_image(fb, width, height), segs


def test_pipeline_matches_mcpt(tmp_path):
    want = jax_child(tmp_path, _JAX_PIPELINE, **_PIPE)
    got, segs = _torch_pipeline(**_PIPE)
    assert got.shape == (16, 16, 3) and got.dtype == np.float32
    assert_parity(got.reshape(-1, 3), want["img"].reshape(-1, 3), segs,
                  float(want["segs"]))


def _config(tmp_path, spp_per_step=1):
    """A one-entry config (with '#' comments) for a 16x16 quad-light render."""
    text = ("{ # test config\n  \"config\": [\n    { # quad light\n"
            "      \"objname\": \"procedural:quad_light_plane\",\n"
            "      \"width\": 16, \"height\": 16, \"maxdepth\": 4,\n"
            f"      \"spp_per_step\": {spp_per_step},\n"
            "      \"integrator\": {\"nee\": true, \"mis\": true}\n"
            "    }\n  ]\n}\n")
    path = tmp_path / "config.json"
    path.write_text(text)
    return str(path)


def _cli(config, out, *extra):
    return render_cli.main(["--config", config, "--out", str(out),
                            "--device", "cpu", *extra])


def test_cli_writes_images(tmp_path, capsys):
    assert _cli(_config(tmp_path, 2), tmp_path / "o", "--spp", "4",
                "--profile") == 0
    text = capsys.readouterr().out
    assert "engine: mega" in text and "Mrays/s" in text
    for ext in ("hdr", "png", "exr"):
        assert (tmp_path / "o" / f"quad_light_plane.{ext}").stat().st_size
    img = im.read_exr_rgb(str(tmp_path / "o" / "quad_light_plane.exr"))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0


_JAX_BVH_BENCH = r"""
import contextlib, functools, io, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from mcpt import scenes
from mcpt.config import load_config
from tools import bvh_bench
a = json.loads(sys.argv[1])
scenes.boxfield = functools.partial(scenes.boxfield, a["boxfield"])
texts = []
for path, cid in a["runs"]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bvh_bench.run_from_config(load_config(path, cid))
    texts.append(out.getvalue())
np.savez(a["out"], texts=np.array(texts))
"""


def _testall_config(tmp_path):
    """Config 5's testall entry (treeletGPU) on cornell_box, furnace_sphere
    and boxfield (made boxfield(60) by the caller), LCV at 48×32."""
    path = tmp_path / "testall.json"
    path.write_text(json.dumps({"config": [{
        "testall": True, "bvhtype": "treeletGPU", "width": 48, "height": 32,
        "objname": ["procedural:cornell_box", "procedural:furnace_sphere",
                    "procedural:boxfield"]}]}))
    return str(path)


@pytest.fixture(scope="module")
def mcpt_bvh_bench(tmp_path_factory):
    """``tools/bvh_bench.py``'s output on config 4 and on the testall
    variant, in the child without FMA (treeletGPU's DP ties, see
    ``test_torch_treelet_device``)."""
    tmp = tmp_path_factory.mktemp("bvh_bench")
    runs = [[os.path.join(ROOT, "config.json"), 4], [_testall_config(tmp), 0]]
    return list(jax_child(tmp, _JAX_BVH_BENCH, runs=runs,
                          boxfield=60)["texts"])


def _metric_lines(text):
    return [line.strip() for line in text.splitlines()
            if line.strip().startswith(("model:", "triangles:", "SAH:",
                                        "EPO:", "LCV:"))]


def _epo_free(lines):
    """The EPO lines without their wall time."""
    return [line.split("  (")[0] for line in lines]


def test_cli_refuses_engines_not_ported(tmp_path, capsys, mcpt_bvh_bench):
    """``cluster-mega`` is ported: on quad_light_plane (4 triangles, no
    cluster BVH) it is the ValueError of ``build_cluster_megascene``, as for
    the hybrid.  The BVH harness is ported too: config 4 (``testbvh``,
    cornell_box, ``treelet``) through the CLI on the CPU prints ``mcpt``'s
    SAH, EPO and LCV to the 4 decimals both print."""
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"config": [{
        "objname": "procedural:quad_light_plane", "width": 8, "height": 8,
        "engine": "cluster-mega"}]}))
    with pytest.raises(ValueError, match="no cluster BVH"):
        _cli(str(path), tmp_path / "o")
    capsys.readouterr()
    assert _cli(os.path.join(ROOT, "config.json"), tmp_path / "o",
                "--configid", "4") == 0
    got = _epo_free(_metric_lines(capsys.readouterr().out))
    want = _epo_free(_metric_lines(mcpt_bvh_bench[0]))
    assert got == want and len(got) == 5, (got, want)
    assert got[-1].startswith("LCV: ") and "skipped" not in got[-1]


def test_cli_testall_small_variant(tmp_path, capsys, monkeypatch,
                                   mcpt_bvh_bench):
    """A testall entry with treeletGPU over three scenes (boxfield(60) for
    the 108k-triangle boxfield) on the CPU: per scene the triangles, the
    treeletGPU build, and ``mcpt``'s SAH, EPO and LCV."""
    import functools

    monkeypatch.setattr(tscenes, "boxfield",
                        functools.partial(tscenes.boxfield, 60))
    assert _cli(_testall_config(tmp_path), tmp_path / "o") == 0
    text = capsys.readouterr().out
    assert text.count("treeletGPU build time: ") == 3
    got = _epo_free(_metric_lines(text))
    want = _epo_free(_metric_lines(mcpt_bvh_bench[1]))
    assert got == want and len(got) == 15, (got, want)


def test_cli_hybrid_needs_clusters(tmp_path):
    """quad_light_plane has 4 triangles: build_scene builds no cluster BVH
    (only past 512), so forcing the hybrid engine is a ValueError."""
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"config": [{
        "objname": "procedural:quad_light_plane", "width": 8, "height": 8,
        "engine": "hybrid"}]}))
    with pytest.raises(ValueError, match="no cluster BVH"):
        _cli(str(path), tmp_path / "o")


def _cli_config(tmp_path, configid, *extra, config=None):
    """render_cli on a config.json entry (or on ``config``) at a tiny size
    on the CPU → its standard output; checks the three images."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert _cli(config or os.path.join(ROOT, "config.json"), tmp_path,
                    "--configid", str(configid), *extra) == 0
    text = out.getvalue()
    stem = text.split("wrote ")[1].split(".hdr")[0]
    for ext in ("hdr", "png", "exr"):
        assert (tmp_path / f"{stem}.{ext}").stat().st_size
    return text, im.read_exr_rgb(str(tmp_path / f"{stem}.exr"))


def test_cli_large_config_takes_the_hybrid(tmp_path):
    """Config 7 (boxfield, 108,004 tris, depth 8, NEE+MIS+RR, 4 spp per
    step) at 8×6 through the plain version: auto routes it to the hybrid."""
    text, img = _cli_config(tmp_path, 7, "--width", "8", "--height", "6",
                            "--spp", "4")
    assert "108004 tris" in text and "engine: hybrid" in text
    assert "pilot caps None" in text  # the pilot runs on CUDA only
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0


@pytest.mark.parametrize("engine", ["cluster-mega", "wavefront"])
def test_cli_config7_through_the_new_engines(tmp_path, engine):
    """Config 7 (boxfield, 108,004 tris, depth 8, NEE+MIS+RR, 4 spp a step)
    at 8×6 through the plain versions, its entry copied with ``engine`` set
    (config.json stays as it is).  On the CPU the wavefront's ``auto``
    intersector is the BVH walk and the resort stays off."""
    from mcpt_torch.config import write_config_variant

    config = write_config_variant(os.path.join(ROOT, "config.json"), 7,
                                  str(tmp_path / "c7.json"), engine=engine)
    text, img = _cli_config(tmp_path, 0, "--width", "8", "--height", "6",
                            "--spp", "4", config=config)
    assert "108004 tris" in text and f"engine: {engine}" in text
    if engine == "wavefront":
        assert "wavefront: intersector bvh | resort off" in text
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0


def test_cli_mesh_config_renders_single_device(tmp_path):
    """Config 9 asks for a samples mesh; with one device the port says so
    and renders single-device, as tools/render.py does."""
    text, img = _cli_config(tmp_path, 9, "--width", "8", "--height", "8",
                            "--spp", "1")
    assert ("config requests a device mesh but only one device is visible "
            "— rendering single-chip") in text
    assert "engine: hybrid" in text
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


def test_checkpoint_resumes_across_clis(tmp_path, capsys):
    """A checkpoint in ``tools/render.py``'s format (written here through
    ``mcpt``'s Framebuffer, as that CLI writes it) resumes under the port and
    ends bit-equal to an uninterrupted render; the port's own checkpoint
    loads the way ``tools/render.py`` loads one."""
    config = _config(tmp_path)
    assert _cli(config, tmp_path / "a", "--spp", "4") == 0
    assert _cli(config, tmp_path / "b", "--spp", "2",
                "--checkpoint-every", "2") == 0
    ckpt = tmp_path / "b" / "quad_light_plane.ckpt.npz"
    z = np.load(ckpt)  # tools/render.py:131-133
    fb = jtypes.Framebuffer(sum=jnp.asarray(z["sum"]),
                            count=jnp.asarray(z["count"]))
    assert int(z["done"]) == 2 and float(fb.count[0]) == 2.0
    z.close()
    np.savez(ckpt, sum=np.asarray(fb.sum), count=np.asarray(fb.count),
             done=2)  # tools/render.py:335-338
    capsys.readouterr()
    assert _cli(config, tmp_path / "b", "--spp", "4", "--resume") == 0
    assert "resumed at 2 spp" in capsys.readouterr().out
    for ext in ("hdr", "exr", "png"):
        assert (tmp_path / "b" / f"quad_light_plane.{ext}").read_bytes() == \
            (tmp_path / "a" / f"quad_light_plane.{ext}").read_bytes()


def test_furnace_identity_plain_version():
    """Diffuse sphere (albedo 0.5) in a uniform emitter (1.0): every sphere
    pixel is exactly 0.5 and every background pixel exactly 1.0."""
    loaded, camcfg = tscenes.furnace_sphere(albedo=0.5, emission=1.0,
                                            subdiv=2)
    scene, lights = build_scene(loaded, device="cpu")
    cam = tcamera.make_camera(dataclasses.replace(camcfg,
                                                  resolution=(16, 16)),
                              device="cpu")
    mega = tmk.build_megascene(scene, lights)
    assert mega.n_tris == 640  # the chunked tier
    rad, segs = tmk.render_mega(mega, cam, 16, 16, spp=8, seed=0,
                                max_depth=6)
    img = rad.numpy().reshape(16, 16, 3) / 8.0
    np.testing.assert_allclose(img[8, 8], 0.5, atol=1e-5)
    np.testing.assert_allclose(img[0, 0], 1.0, atol=1e-5)
    assert float(segs) > 0.0


@pytest.mark.parametrize("name,w,h,spp,depth,tol", [
    # 16 spp MC noise on cbox measures ~0.11 rel-RMSE (tests/test_golden.py)
    ("cornell_box", 128, 128, 16, 16, 0.22),
    ("quad_light_plane", 128, 128, 8, 6, 0.25),
])
def test_golden_gates_plain_version(name, w, h, spp, depth, tol):
    golden = im.read_exr_rgb(os.path.join(ROOT, "tests", "goldens",
                                          f"{name}.exr"))[::-1]
    loaded, camcfg = getattr(tscenes, name)()
    scene, lights = build_scene(loaded, device="cpu")
    cam = tcamera.make_camera(dataclasses.replace(camcfg, resolution=(w, h)),
                              device="cpu")
    rad, _ = tmk.render_mega(tmk.build_megascene(scene, lights), cam, w, h,
                             spp=spp, seed=5, max_depth=depth, nee=True,
                             mis=True)
    img = rad.numpy().reshape(h, w, 3) / spp
    stats = compare(img.astype(np.float64), golden.astype(np.float64))
    assert stats["rel_rmse"] < tol, stats
