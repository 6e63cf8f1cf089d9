"""The port's wavefront engine against ``mcpt``'s, on the CPU.

The threefry draws are ``jax.random``'s bits (``tests/test_torch_rng.py``),
so the same key gives the same paths:

- the intersectors (Möller–Trumbore, brute force, Wald, the BVH stack walk)
  against ``mcpt``'s in this process on random triangles and rays: the same
  triangle for every ray, and t within 5e-6 relative through
  Möller–Trumbore and 5e-5 through the Wald transforms.  XLA contracts
  multiply-adds in this process, and the cancellation in the determinant
  and in t = -op_z/dp_z turns that ulp into up to 2.2e-6 and 2.9e-5
  relative (measured on this soup; ``render_batch`` below runs ``mcpt``
  without FMA);
- ``generate_rays`` and ``shade`` on a fixed pool and key: the same alive
  mask, floats within 1e-5 relative (the same ulp-level reason; XLA's sin,
  cos and pow also differ from PyTorch's by an ulp on a few % of values);
- ``render_batch`` against ``mcpt``'s ``render_batch`` run in a child process
  without FMA (``test_torch_megakernel.jax_child``) at 32×32, spp 2, depth 3
  — brute force on quad_light, the BVH walk with the resort on
  boxfield(60), one run with a tight compaction cap — under the dense
  path's gate (≥ 99% of pixels within |a-b| ≤ 1e-4·|b| + 1e-5, image means
  within 1e-3, segments within 0.1%);
- the furnace identity, with and without the resort.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt.render import camera as jcamera
from mcpt.render import shade as jshade
from mcpt.render import traverse as jtraverse
from mcpt.scene import build_scene as jbuild_scene
from mcpt.scene import loaded_from_arrays as jloaded_from_arrays
from mcpt.types import Hit as JHit
from mcpt.types import RayPool as JRayPool
from mcpt_torch import convert, rng
from mcpt_torch.bvh.lbvh import one_thread
from mcpt_torch import scenes as tscenes
from mcpt_torch.render import camera as tcamera
from mcpt_torch.render import integrator as tinteg
from mcpt_torch.render import shade as tshade
from mcpt_torch.render import traverse as ttraverse
from mcpt_torch.scene import build_scene, loaded_from_arrays
from test_torch_megakernel import assert_parity, jax_child


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run loops of small CPU ops; with several test workers on
    the same cores, PyTorch's intra-op threads spin against each other
    (``mcpt_torch.bvh.lbvh.one_thread``)."""
    with one_thread():
        yield


def _jkey(k: rng.Key):
    return jax.random.wrap_key_data(np.array([k.k1, k.k2], np.uint32))


@pytest.fixture(scope="module")
def soup():
    """200 random triangles in a box (one diffuse material) in both
    packages, and 3000 rays from random points in random directions."""
    r = np.random.default_rng(5)
    centres = r.uniform(-10.0, 10.0, (200, 1, 3))
    verts = (centres + r.normal(scale=1.5, size=(200, 3, 3))).astype(
        np.float32)
    arrays = dict(verts=verts, mat_id=np.zeros(200, np.int32),
                  mtype=np.array([1], np.int32), kd=np.full((1, 3), 0.5),
                  ks=np.zeros((1, 3)), ka=np.zeros((1, 3)),
                  ns=np.ones(1), ni=np.ones(1))
    scene, _ = build_scene(loaded_from_arrays(**arrays), device="cpu")
    jscene, _ = jbuild_scene(jloaded_from_arrays(**arrays))
    o = r.uniform(-14.0, 14.0, (3000, 3)).astype(np.float32)
    d = r.normal(size=(3000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return scene, jscene, o, d


def _same_hits(got, want_t, want_tri, rtol):
    want_t, want_tri = np.asarray(want_t), np.asarray(want_tri)
    np.testing.assert_array_equal(got.tri.numpy(), want_tri)
    hit = want_tri >= 0
    assert 500 < hit.sum() < 2900  # rays hit and miss
    np.testing.assert_allclose(got.t.numpy()[hit], want_t[hit], rtol=rtol)
    assert np.isinf(got.t.numpy()[~hit]).all()


@pytest.mark.parametrize("method", ["moller_trumbore", "brute", "wald",
                                    "bvh"])
def test_intersectors_match_mcpt(soup, method):
    scene, jscene, o, d = soup
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    if method == "moller_trumbore":
        v = scene.geom.verts[:64]
        t, hit = ttraverse.moller_trumbore(to[:, None], td[:, None],
                                           v[None, :, 0], v[None, :, 1],
                                           v[None, :, 2])
        jv = jscene.geom.verts[:64]
        jt, jhit = jtraverse.moller_trumbore(
            jnp.asarray(o)[:, None], jnp.asarray(d)[:, None], jv[None, :, 0],
            jv[None, :, 1], jv[None, :, 2])
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=5e-6)
        return
    if method == "brute":
        got = ttraverse.intersect_brute(scene.geom, to, td)
        want = jtraverse.intersect_brute(jscene.geom, jnp.asarray(o),
                                         jnp.asarray(d))
    elif method == "wald":
        got = ttraverse.intersect_wald(scene.wald, scene.geom, to, td)
        want = jtraverse.intersect_wald(jscene.wald, jscene.geom,
                                        jnp.asarray(o), jnp.asarray(d))
    else:
        active = np.arange(3000) % 7 != 0
        got = ttraverse.intersect_bvh(scene.bvh, scene.geom, to, td,
                                      active=torch.from_numpy(active))
        want = jtraverse.intersect_bvh(jscene.bvh, jscene.geom,
                                       jnp.asarray(o), jnp.asarray(d),
                                       active=jnp.asarray(active))
        assert (got.tri.numpy()[~active] == -1).all()
    _same_hits(got, want.t, want.tri, 5e-5 if method == "wald" else 5e-6)
    hit = np.asarray(want.tri) >= 0
    np.testing.assert_allclose(got.normal.numpy()[hit],
                               np.asarray(want.normal)[hit], rtol=0, atol=0)


@pytest.fixture(scope="module")
def cbox():
    loaded, camcfg = tscenes.cornell_box()
    camcfg = dataclasses.replace(camcfg, resolution=(24, 20))
    scene, lights = build_scene(loaded, device="cpu")
    from mcpt import scenes as jscenes

    jloaded, _ = jscenes.cornell_box()
    jscene, _ = jbuild_scene(jloaded)
    cam = tcamera.make_camera(camcfg, device="cpu")
    return scene, lights, cam, jscene, camcfg


def test_generate_rays_match_mcpt(cbox):
    _, _, cam, _, camcfg = cbox
    key = rng.fold_in(rng.key(11), 3)
    pool = tcamera.generate_rays(cam, 24, 20, key=key)
    want = jcamera.generate_rays(jcamera.make_camera(camcfg), 24, 20,
                                 key=_jkey(key))
    np.testing.assert_array_equal(pool.pixel.numpy(), np.asarray(want.pixel))
    np.testing.assert_allclose(pool.origin.numpy(), np.asarray(want.origin),
                               rtol=1e-6)
    np.testing.assert_allclose(pool.direction.numpy(),
                               np.asarray(want.direction), rtol=1e-5,
                               atol=1e-7)


def test_shade_matches_mcpt(cbox):
    """One bounce of a camera pool with some dead rays, NEE's inputs and
    Russian roulette on, through both ``shade``s on the same hit and key."""
    scene, _, cam, jscene, _ = cbox
    pool = tcamera.generate_rays(cam, 24, 20, key=rng.key(2))
    pool = pool._replace(alive=torch.arange(480) % 5 != 0,
                         inside=torch.arange(480) % 3 == 0)
    hit = ttraverse.intersect_scene(scene, pool.origin, pool.direction,
                                    active=pool.alive, method="brute")
    key = rng.split(rng.key(9), 3)[2]
    e_scale = torch.linspace(0.2, 1.0, 480)
    got = tshade.shade(scene.materials, scene.geom.mat_id, pool, hit, key,
                       4, 8, rr_enabled=True, rr_start_depth=3,
                       emission_scale=e_scale, eps=scene.eps)
    jpool = JRayPool(**{k: jnp.asarray(v) for k, v in
                        convert.raypool_to_numpy(pool).items()})
    jhit = JHit(**{k: jnp.asarray(v) for k, v in
                   convert.hit_to_numpy(hit).items()})
    want = jshade.shade(jscene.materials, jscene.geom.mat_id, jpool, jhit,
                        _jkey(key), 4, 8, rr_enabled=True, rr_start_depth=3,
                        emission_scale=jnp.asarray(e_scale.numpy()),
                        eps=jscene.eps)
    assert int(got.pool.alive.sum()) > 50
    for name in ("alive", "inside", "pixel"):
        np.testing.assert_array_equal(getattr(got.pool, name).numpy(),
                                      np.asarray(getattr(want.pool, name)))
    np.testing.assert_array_equal(got.scatter.numpy(),
                                  np.asarray(want.scatter))
    for name in ("origin", "direction", "throughput", "radiance"):
        np.testing.assert_allclose(getattr(got.pool, name).numpy(),
                                   np.asarray(getattr(want.pool, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got.bsdf_pdf.numpy(),
                               np.asarray(want.bsdf_pdf), rtol=1e-5,
                               atol=1e-6)


_JAX_WAVEFRONT = r"""
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from mcpt import scenes
from mcpt.render import camera as cm
from mcpt.render import integrator as integ
from mcpt.scene import build_scene
a = json.loads(sys.argv[1])
loaded, camcfg = getattr(scenes, a["scene"])(**a["scene_kw"])
camcfg = dataclasses.replace(camcfg, resolution=(a["w"], a["h"]))
scene, lights = build_scene(loaded)
opts = dict(a["opts"])
if opts.get("compact") is not None:
    opts["compact"] = tuple(opts["compact"])
rad, segs = integ.render_batch(scene, lights, cm.make_camera(camcfg), a["w"],
                               a["h"], jax.random.key(a["seed"]),
                               integ.RenderOptions(**opts), spp=a["spp"],
                               with_stats=True)
np.savez(a["out"], rad=np.asarray(rad), segs=float(segs))
"""


def torch_render_batch(scene_name, w, h, seed, spp, opts, scene_kw=None):
    loaded, camcfg = getattr(tscenes, scene_name)(**(scene_kw or {}))
    camcfg = dataclasses.replace(camcfg, resolution=(w, h))
    scene, lights = build_scene(loaded, device="cpu")
    opts = dict(opts, compact=(tuple(opts["compact"]) if opts.get("compact")
                               else None))
    rad, segs = tinteg.render_batch(
        scene, lights, tcamera.make_camera(camcfg, device="cpu"), w, h,
        rng.key(seed),
        tinteg.RenderOptions(**opts), spp=spp, with_stats=True)
    return rad.numpy(), float(segs)


@pytest.mark.parametrize("scene_name,scene_kw,seed,opts", [
    ("quad_light_plane", {}, 3,
     dict(max_depth=3, nee=True, mis=True, method="brute")),
    ("boxfield", {"n_boxes": 60}, 4,
     dict(max_depth=3, nee=True, mis=True, russian_roulette=True,
          rr_start_depth=1, method="bvh", resort=True)),
    # 2048 rays: the 0.3 cap keeps 1024 of them after bounce 0
    ("boxfield", {"n_boxes": 60}, 6,
     dict(max_depth=3, nee=True, mis=True, method="bvh",
          compact=[0.3, 0.2])),
])
def test_render_batch_matches_mcpt(tmp_path, scene_name, scene_kw, seed,
                                   opts):
    want = jax_child(tmp_path, _JAX_WAVEFRONT, scene=scene_name,
                     scene_kw=scene_kw, w=32, h=32, seed=seed, spp=2,
                     opts=opts)
    got, segs = torch_render_batch(scene_name, 32, 32, seed, 2, opts,
                                   scene_kw)
    assert got.mean() > 0.0
    assert_parity(got, want["rad"], segs, float(want["segs"]))


@pytest.fixture(scope="module")
def furnace():
    loaded, camcfg = tscenes.furnace_sphere(albedo=0.5, emission=1.0,
                                            subdiv=2)
    scene, lights = build_scene(loaded, device="cpu")
    return scene, lights, tcamera.make_camera(camcfg, device="cpu")


@pytest.mark.parametrize("resort", [False, True])
def test_furnace_identity(furnace, resort):
    """A convex diffuse body (albedo 0.5) in a uniform emitter (1.0): every
    path that meets the body returns exactly 0.5, the background exactly
    1.0 (``tests/test_integrator.py:41``), with the pool re-sorted between
    bounces or not."""
    scene, lights, cam = furnace
    opts = tinteg.RenderOptions(max_depth=8, method="bvh", resort=resort)
    fb = tinteg.render(scene, lights, cam, 32, 32, opts, spp=2, seed=0,
                       spp_per_step=2)
    img = tinteg.framebuffer_image(fb, 32, 32)
    np.testing.assert_allclose(img[16, 16], 0.5, atol=1e-5)
    np.testing.assert_allclose(img[1, 1], 1.0, atol=1e-5)


def test_loop_modes_agree(furnace):
    """``fori``, ``unroll`` and ``while`` trace the same paths."""
    scene, lights, cam = furnace
    out = []
    for loop in ("fori", "unroll", "while"):
        opts = tinteg.RenderOptions(max_depth=5, nee=True, mis=True,
                                    method="bvh", loop=loop)
        out.append(tinteg.render_batch(scene, lights, cam, 8, 8,
                                       rng.key(1), opts, spp=2,
                                       with_stats=True))
    for rad, segs in out[1:]:
        assert torch.equal(rad, out[0][0]) and float(segs) == float(out[0][1])


def test_pilot_schedule_equals_mcpt():
    """``measure_schedule`` (``mcpt``'s wavefront pilot) on boxfield(60)
    with Russian roulette, 32×32: the same caps.  A cap is a live share
    rounded up to 1/64, so an ulp of ``mcpt``'s in-process arithmetic moves
    it only if a path's survival flips exactly at a rounding edge."""
    from mcpt import scenes as jscenes
    from mcpt.render import integrator as jinteg

    opts = dict(max_depth=6, russian_roulette=True, rr_start_depth=1,
                method="bvh")
    loaded, camcfg = tscenes.boxfield(60)
    scene, lights = build_scene(loaded, device="cpu")
    got = tinteg.measure_schedule(scene, lights,
                                  tcamera.make_camera(camcfg, device="cpu"),
                                  tinteg.RenderOptions(**opts), 32, 32, seed=3)
    jloaded, jcamcfg = jscenes.boxfield(60)
    jscene, jlights = jbuild_scene(jloaded)
    want = jinteg.measure_schedule(jscene, jlights,
                                   jcamera.make_camera(jcamcfg),
                                   jinteg.RenderOptions(**opts), 32, 32,
                                   seed=3)
    assert len(got) == 5 and got == want
