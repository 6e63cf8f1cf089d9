"""Host tier of the PyTorch port against ``mcpt``: the counter-hash RNG,
config parsing, procedural scenes, scene build tables, camera, megakernel
tables, image writers, .obj loading and state conversion.  Inputs are made
with numpy from fixed seeds and given to both packages."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt import config as jconfig
from mcpt import scenes as jscenes
from mcpt import types as jtypes
from mcpt.io import image as jimage
from mcpt.io import objloader as jobj
from mcpt.pallas import cluster_megakernel as jcmk
from mcpt.pallas import megakernel as jmk
from mcpt.render import camera as jcamera
from mcpt.scene import build_lights as j_build_lights
from mcpt.scene import build_scene as j_build_scene
from mcpt.scene import build_wald as j_build_wald
from mcpt_torch import config as tconfig
from mcpt_torch import convert
from mcpt_torch import scenes as tscenes
from mcpt_torch.io import image as timage
from mcpt_torch.io import objloader as tobj
from mcpt_torch.kernels import _build
from mcpt_torch.kernels import megakernel as tmk
from mcpt_torch.render import camera as tcamera
from mcpt_torch.scene import build_lights as t_build_lights
from mcpt_torch.scene import build_scene as t_build_scene
from mcpt_torch.scene import build_wald as t_build_wald
from mcpt_torch.types import Framebuffer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ["cornell_box", "veach_mis", "quad_light_plane", "furnace_sphere"]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _hash_inputs():
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, -1, 2**31 - 1, -(2**31), 2**31 - 2, -(2**31) + 1,
                     -123456789, 0x7FFF0000], np.int64)
    rand = rng.integers(-(2**31), 2**31, 4096, dtype=np.int64)
    return np.concatenate([edge, rand]).astype(np.int32)


def test_fmix32_bit_equal():
    x = _hash_inputs()
    want = np.asarray(jmk._fmix32(jnp.asarray(x))).astype(np.int64) & 0xFFFFFFFF
    got = tmk._fmix32(torch.from_numpy(x.astype(np.int64))).numpy()
    _eq(got, want)


@pytest.mark.parametrize("seed,salt", [(0, 0), (7, 3), (-5, 11),
                                       (2**31 - 1, 2**31 - 1),
                                       (-(2**31), 131)])
def test_u01_bit_equal(seed, salt):
    idx = _hash_inputs()
    want = np.asarray(jmk._u01(jnp.int32(seed), jnp.int32(salt),
                               jnp.asarray(idx)))
    got = tmk._u01(seed, salt, torch.from_numpy(idx.astype(np.int64)))
    assert got.dtype == torch.float32
    _eq(got.numpy(), want)


def test_all_config_entries_parse_equal():
    with open(os.path.join(ROOT, "config.json")) as f:
        text = f.read()
    for cid in range(10):
        j = jconfig.parse_config_text(text, cid)
        t = tconfig.parse_config_text(text, cid)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), cid
    assert tconfig.strip_json_comments('{"a": "#x"} # c') == '{"a": "#x"} '


@pytest.mark.parametrize("name", ["cornell_box", "veach_mis",
                                  "quad_light_plane", "furnace_sphere",
                                  "boxfield", "diningroom"])
def test_procedural_scenes_equal(name):
    jl, jc = getattr(jscenes, name)()
    tl, tc = getattr(tscenes, name)()
    for f in ("verts", "mat_id", "mtype", "kd", "ks", "ka", "ns", "ni"):
        _eq(getattr(tl, f), getattr(jl, f))
        assert getattr(tl, f).dtype == getattr(jl, f).dtype, f
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


@pytest.mark.parametrize("name", SCENES)
def test_scene_and_megascene_tables_equal(name):
    jl, jc = getattr(jscenes, name)()
    tl, tc = getattr(tscenes, name)()
    jw, tw = j_build_wald(jl.verts), t_build_wald(tl.verts, "cpu")
    _eq(tw.w, jw.w)
    _eq(tw.b, jw.b)
    jlights = j_build_lights(jl.verts, jl.mat_id, jl.mtype, jl.ka)
    tlights = t_build_lights(tl.verts, tl.mat_id, tl.mtype, tl.ka, "cpu")
    for f in ("tri", "cdf", "emission", "total_area"):
        _eq(getattr(tlights, f), getattr(jlights, f))
    tscene, tlights = t_build_scene(tl, device="cpu")
    jscene, jlights = j_build_scene(jl)
    _eq(tscene.eps, jscene.eps)
    _eq(tscene.geom.normals, jscene.geom.normals)
    # the LBVH of every scene, and past 512 tris the cluster BVH
    for f in tscene.bvh._fields:
        _eq(getattr(tscene.bvh, f), getattr(jscene.bvh, f))
    assert (tscene.clusters is None) == (jl.verts.shape[0] <= 512)
    if tscene.clusters is not None:  # mcpt's fields (the port adds two)
        for f in jscene.clusters._fields:
            _eq(getattr(tscene.clusters, f), getattr(jscene.clusters, f))
    jm = jmk.build_megascene(jscene, jlights)
    tm = tmk.build_megascene(tscene, tlights)
    for f in ("tri", "cbox", "matt", "lit"):
        assert getattr(tm, f).dtype == torch.float32
        _eq(getattr(tm, f), getattr(jm, f))
    for f in ("n_tris", "n_mats", "n_lights", "eps", "total_light_area"):
        assert getattr(tm, f) == pytest.approx(getattr(jm, f), rel=0, abs=0)
    if tm.n_tris > tmk.UNROLL_MAX_TRIS:
        assert tm.tri.shape[0] % tmk.CHUNK_TRIS == 0
        assert tm.cbox.shape[0] == tm.tri.shape[0] // tmk.CHUNK_TRIS


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("ortho", [None, 3.0])
def test_make_camera_equal(name, ortho):
    _, jc = getattr(jscenes, name)()
    _, tc = getattr(tscenes, name)()
    jc = dataclasses.replace(jc, resolution=(24, 16))
    tc = dataclasses.replace(tc, resolution=(24, 16))
    j = jcamera.make_camera(jc, ortho_height=ortho)
    t = tcamera.make_camera(tc, ortho_height=ortho, device="cpu")
    for f in j._fields:
        assert getattr(t, f).dtype == torch.float32, f
        _eq(getattr(t, f), getattr(j, f))
    with pytest.raises(ValueError):
        tcamera.make_camera(dataclasses.replace(tc, fov=0.0),
                            device="cpu")


def test_image_writers_byte_equal(tmp_path):
    rng = np.random.default_rng(3)
    img = (rng.random((13, 17, 3)) * 4.0).astype(np.float32)
    img[0, 0] = 0.0
    for mod, tag in ((jimage, "j"), (timage, "t")):
        mod.write_hdr(str(tmp_path / f"{tag}.hdr"), img)
        mod.write_png(str(tmp_path / f"{tag}.png"), mod.tonemap_srgb(img))
        mod.write_exr(str(tmp_path / f"{tag}.exr"), img)
        mod.write_exr(str(tmp_path / f"{tag}32.exr"), img, half=False)
    for ext in ("hdr", "png", "exr"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes(), ext
    assert (tmp_path / "t32.exr").read_bytes() == \
        (tmp_path / "j32.exr").read_bytes()
    _eq(timage.read_exr_rgb(str(tmp_path / "t32.exr")), img)
    _eq(timage.read_hdr(str(tmp_path / "t.hdr")),
        jimage.read_hdr(str(tmp_path / "j.hdr")))


def test_objloader_equal(tmp_path):
    loaded, _ = jscenes.cornell_box()
    jobj.write_object(loaded, str(tmp_path), "cbox.obj")
    j = jobj.load_object(str(tmp_path), "cbox.obj", use_native="never")
    t = tobj.load_object(str(tmp_path), "cbox.obj")
    for f in ("verts", "mat_id", "mtype", "kd", "ks", "ka", "ns", "ni"):
        _eq(getattr(t, f), getattr(j, f))
    assert t.mat_names == j.mat_names
    raw = tobj.parse_mtl(str(tmp_path / "cbox.mtl"))
    _eq(np.stack(tobj.classify_materials(raw)[1]),
        np.stack(jobj.classify_materials(
            jobj.parse_mtl(str(tmp_path / "cbox.mtl")))[1]))
    geom, mats = t.to_device("cpu")
    assert geom.verts.device.type == "cpu" and mats.count == len(raw)


def test_convert_round_trips(tmp_path):
    jl, jc = jscenes.veach_mis()
    jscene, jlights = j_build_scene(jl)
    jm = jmk.build_megascene(jscene, jlights)
    tm = convert.megascene_from_numpy(
        {k: (v if isinstance(v, (int, float)) else np.asarray(v))
         for k, v in jm._asdict().items()}, "cpu")
    back = convert.megascene_to_numpy(tm)
    for k, v in jm._asdict().items():
        _eq(back[k], v)
    cam = jcamera.make_camera(jc)
    tcam = convert.camera_from_numpy(
        {k: np.asarray(v) for k, v in cam._asdict().items()}, "cpu")
    for k, v in convert.camera_to_numpy(tcam).items():
        _eq(v, getattr(cam, k))
    # the cluster tables of a clustered scene (past 512 tris)
    jscene, jlights = j_build_scene(jscenes.furnace_sphere()[0])
    jcms = jcmk.build_cluster_megascene(jscene, jlights)
    tcl = convert.clusterbvh_from_numpy(
        {k: np.asarray(v) for k, v in jscene.clusters._asdict().items()},
        "cpu")
    for k, v in convert.clusterbvh_to_numpy(tcl).items():
        _eq(v, getattr(jscene.clusters, k))
    assert tcl.tri_map.dtype == torch.int32 and tcl.n_clusters == \
        jscene.clusters.n_clusters
    tcms = convert.clustermegascene_from_numpy(
        {k: (v if isinstance(v, (int, float, tuple)) else np.asarray(v))
         for k, v in jcms._asdict().items()}, "cpu")
    for k, v in convert.clustermegascene_to_numpy(tcms).items():
        if isinstance(v, tuple):
            assert v == tuple(getattr(jcms, k)), k
        else:
            _eq(v, getattr(jcms, k))
    rng = np.random.default_rng(1)
    s = rng.random((6, 3)).astype(np.float32)
    c = np.full(6, 4.0, np.float32)
    fb = convert.framebuffer_from_numpy(s, c, "cpu")
    jfb = jtypes.Framebuffer(sum=jnp.asarray(s), count=jnp.asarray(c))
    _eq(fb.mean, jfb.mean)
    path = str(tmp_path / "x.ckpt.npz")
    convert.save_checkpoint(path, fb, 4)
    fb2, done = convert.load_checkpoint(path, "cpu")
    assert done == 4 and isinstance(fb2, Framebuffer)
    _eq(fb2.sum, s)
    _eq(fb2.count, c)


def test_dispatcher_contracts():
    """CPU tensors take the plain version; the CUDA wrapper rejects what the
    kernel cannot take (a CPU tensor, another dtype, a strided view)."""
    tl, tc = tscenes.quad_light_plane()
    scene, lights = t_build_scene(tl, device="cpu")
    mega = tmk.build_megascene(scene, lights)
    cam = tcamera.make_camera(dataclasses.replace(tc, resolution=(4, 4)),
                              device="cpu")
    a = tmk.render_mega(mega, cam, 4, 4, spp=2, seed=1, nee=True, mis=True)
    b = tmk.render_mega_reference(mega, cam, 4, 4, spp=2, seed=1, nee=True,
                                  mis=True)
    _eq(a[0], b[0])
    assert a[1].dtype == torch.float64
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda("x", torch.zeros(4))
    with pytest.raises(ValueError):
        tmk.render_mega(mega._replace(tri=mega.tri.to("meta")), cam, 4, 4,
                        spp=1, seed=0)
    with pytest.raises(ValueError, match="schedule"):
        tmk.render_mega(mega, cam, 4, 4, spp=1, seed=0, schedule="x")
    assert _build.library_path().parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "mcpt_torch")
    assert len(_build.source_hash()) == 16


@pytest.mark.parametrize("builder", ["build_scene", "make_camera", "bits",
                                     "uniform"])
def test_builders_default_to_the_card(builder):
    """``build_scene``, ``make_camera``, ``rng.bits`` and ``rng.uniform``
    place their results on the card unless the caller names another device,
    as ``mcpt``'s land on the accelerator: with a CUDA device they give CUDA
    tensors; without one they raise instead of handing back CPU tensors."""
    from mcpt_torch import rng

    loaded, camcfg = tscenes.quad_light_plane()
    call = {
        "build_scene": lambda: t_build_scene(loaded)[0].geom.verts,
        "make_camera": lambda: tcamera.make_camera(camcfg).position,
        "bits": lambda: rng.bits(rng.key(1), (4,)),
        "uniform": lambda: rng.uniform(rng.key(1), (4,)),
    }[builder]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call()
