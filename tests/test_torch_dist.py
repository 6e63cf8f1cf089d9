"""The port's sharded rendering (``mcpt_torch.dist``) on the CPU, over gloo.

One world of 8 ranks (one process each, a ``file://`` rendezvous in the
test's temporary directory) is spawned once for the module and runs every
case; each rank saves what it got, and the tests read it:

- mesh shapes (1,8), (8,1), (2,4), (4,2) over the 8 ranks, as in
  ``tests/test_dist.py``, and (2,3) over ranks 0-5.  At 20×20 the slices
  of 8 and 3 pixel shards start mid-row and mid 8×4 tile (50, 134, 268),
  and 400 pixels do not divide by 3, so the (2,3) mesh's last slice is
  padded;
- the kernel engines' plain versions (dense megakernel on cbox, cluster
  megakernel and hybrid on boxfield(60)) sharded equal one device: radiance
  to rtol 1e-5 (only the f32 sum order differs), segments exactly, on every
  rank and for every mesh shape;
- the furnace identity through the sharded wavefront on the padded (2,3)
  mesh, and the sharded wavefront against ``mcpt``'s ``render_batch_sharded``
  on the same mesh shapes, with ``mcpt`` in a child process on 8 host
  devices without FMA (``test_torch_megakernel.jax_child``), under the
  dense path's gate (≥ 99% of pixels within 1e-4·|b| + 1e-5, means within
  1e-3, segments within 0.1%);
- the sharded hybrid builds its row order once per ``pixels`` extent;
- the hybrid with compaction is finite; ``render_sharded`` accumulates the
  rounded spp and agrees with one device in expectation;
- ``render_cli`` on a ``mesh`` config under ``torchrun`` with 2 ranks equals
  the one-process render (the CPU hybrid runs no pilot, so to rtol 1e-5).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mcpt_torch import dist, render_cli
from mcpt_torch.bvh.lbvh import one_thread
from test_torch_megakernel import ROOT, assert_parity, jax_child

W = H = 20
SPP = 8
MESHES = {"1x8": (1, 8, None), "8x1": (8, 1, None), "2x4": (2, 4, None),
          "4x2": (4, 2, None), "2x3": (2, 3, list(range(6)))}
WAVEFRONT_MESHES = ("2x3", "4x2")
ENGINE_KW = {
    "mega": dict(seed=3, max_depth=4, nee=True, mis=True, rr=True),
    "cluster": dict(seed=5, max_depth=3, nee=True, mis=True, rr=True),
    "hybrid": dict(seed=7, max_depth=3, nee=True, mis=True, rr=True),
}
WAVEFRONT = dict(scene="quad_light_plane", spp=4, seed=1, max_depth=3)

_RANK = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as tdist
torch.set_num_threads(1)
a = json.loads(sys.argv[1])
rank = int(sys.argv[2])
tdist.init_process_group("gloo", init_method=a["init"], rank=rank,
                         world_size=a["world"])
from mcpt_torch import dist, rng, scenes
from mcpt_torch.kernels import cluster_megakernel as cmk
from mcpt_torch.kernels import megakernel as mk
from mcpt_torch.render import integrator as integ
from mcpt_torch.render.camera import make_camera
from mcpt_torch.scene import build_scene


def setup(name, w, h, *args, **kw):
    loaded, camcfg = getattr(scenes, name)(*args, **kw)
    scene, lights = build_scene(loaded, device="cpu")
    cam = make_camera(dataclasses.replace(camcfg, resolution=(w, h)),
                      device="cpu")
    return scene, lights, cam


w = h = a["size"]
spp = a["spp"]
out = {}
cb, cb_lights, cb_cam = setup("cornell_box", w, h)
mega = mk.build_megascene(cb, cb_lights)
bf, bf_lights, bf_cam = setup("boxfield", w, h, 60)
cms = cmk.build_cluster_megascene(bf, bf_lights)
fu, fu_lights, fu_cam = setup("furnace_sphere", w, h, albedo=0.5,
                              emission=1.0, subdiv=2)
wf = a["wavefront"]
ql, ql_lights, ql_cam = setup(wf["scene"], w, h)
ql_opts = integ.RenderOptions(max_depth=wf["max_depth"], method="brute",
                              nee=True, mis=True)
try:
    dist.make_mesh(samples=3)
except ValueError:
    out["bad_shape_raises"] = 1
meshes = {}
for tag, (s, p, ranks) in a["meshes"].items():
    mesh = meshes[tag] = dist.make_mesh(samples=s, pixels=p, ranks=ranks)
    coords = [None] * a["world"]
    tdist.all_gather_object(coords, (mesh.si, mesh.pi))
    out["coords/" + tag] = np.array([c if c[0] is not None else (-1, -1)
                                     for c in coords])
    if mesh.si is None:
        try:
            dist.render_mega_sharded(mega, cb_cam, w, h, spp, mesh)
        except ValueError:
            out["outside_raises"] = 1
        continue
    runs = {
        "mega": lambda kw: dist.render_mega_sharded(
            mega, cb_cam, w, h, spp, mesh, **kw),
        "cluster": lambda kw: dist.render_cluster_sharded(
            cms, bf_cam, w, h, spp, mesh, **kw),
        "hybrid": lambda kw: dist.render_hybrid_sharded(
            cms, bf_cam, w, h, spp, mesh, **kw),
    }
    for engine, fn in runs.items():
        rad, segs = fn(a["engine_kw"][engine])
        out[f"{engine}/{tag}"] = rad.numpy()
        out[f"{engine}/{tag}/segs"] = float(segs)
    out["rows_misses/" + tag] = dist._shard_rows.cache_info().misses
    if tag in a["wavefront_meshes"]:
        rad, segs = dist.render_batch_sharded(
            ql, ql_lights, ql_cam, w, h, rng.key(wf["seed"]), ql_opts,
            wf["spp"], mesh, with_stats=True)
        out["wavefront/" + tag] = rad.numpy()
        out["wavefront/" + tag + "/segs"] = float(segs)
m23, m24, m42 = meshes["2x3"], meshes["2x4"], meshes["4x2"]
if m23.si is not None:
    out["furnace"] = dist.render_batch_sharded(
        fu, fu_lights, fu_cam, w, h, rng.key(0),
        integ.RenderOptions(max_depth=8, method="bvh"), 4, m23).numpy()
opts4 = integ.RenderOptions(max_depth=4, method="bvh")
out["repeat"] = np.stack([dist.render_batch_sharded(
    fu, fu_lights, fu_cam, w, h, rng.key(3), opts4, 2, m24).numpy()
    for _ in range(2)])
rad, segs = dist.render_hybrid_sharded(
    cms, bf_cam, w, h, 2, m24, seed=7, max_depth=3, nee=True, mis=True,
    compact=(0.9, 0.75))
out["compact"], out["compact/segs"] = rad.numpy(), float(segs)
fb = dist.render_sharded(ql, ql_lights, ql_cam, w, h, ql_opts, spp=30,
                         mesh=m42, seed=0, spp_per_step=8)
out["progressive/mean"] = fb.mean.numpy()
out["progressive/count"] = fb.count.numpy()
np.savez(a["out"] + f".{rank}.npz", **out)
tdist.barrier()
tdist.destroy_process_group()
"""

_JAX_SHARDED = r"""
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from mcpt import dist, scenes
from mcpt.render import camera as cm
from mcpt.render.integrator import RenderOptions
from mcpt.scene import build_scene
a = json.loads(sys.argv[1])
wf = a["wavefront"]
loaded, camcfg = getattr(scenes, wf["scene"])()
camcfg = dataclasses.replace(camcfg, resolution=(a["w"], a["h"]))
scene, lights = build_scene(loaded)
cam = cm.make_camera(camcfg)
opts = RenderOptions(max_depth=wf["max_depth"], method="brute", nee=True,
                     mis=True)
out = {}
for tag, (s, p) in a["meshes"].items():
    mesh = dist.make_mesh(samples=s, pixels=p, devices=jax.devices()[:s * p])
    rad, segs = dist.render_batch_sharded(
        scene, lights, cam, a["w"], a["h"], jax.random.key(wf["seed"]), opts,
        spp=wf["spp"], mesh=mesh, with_stats=True)
    out[tag] = np.asarray(rad)
    out[tag + "/segs"] = float(segs)
np.savez(a["out"], **out)
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Loops of small CPU ops (``mcpt_torch.bvh.lbvh.one_thread``)."""
    with one_thread():
        yield


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the 8-rank world (and, beside it, ``mcpt``'s sharded wavefront
    in its child) once → (rank → its saved arrays, ``mcpt``'s arrays)."""
    tmp = tmp_path_factory.mktemp("world")
    args = json.dumps(dict(
        init=f"file://{tmp / 'rendezvous'}", world=8, size=W, spp=SPP,
        meshes=MESHES, wavefront_meshes=WAVEFRONT_MESHES,
        engine_kw=ENGINE_KW, wavefront=WAVEFRONT, out=str(tmp / "rank")))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, args, str(r)],
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(8)]
    try:
        mcpt_out = jax_child(
            tmp, _JAX_SHARDED, host_devices=8, w=W, h=H, wavefront=WAVEFRONT,
            meshes={t: MESHES[t][:2] for t in WAVEFRONT_MESHES})
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    ranks = {}
    for r in range(8):
        with np.load(tmp / f"rank.{r}.npz") as z:
            ranks[r] = {k: z[k] for k in z.files}
    return ranks, mcpt_out


def _one_device(engine):
    """The engine's plain version on one device at the world's arguments."""
    import dataclasses

    from mcpt_torch import scenes
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.kernels import megakernel as mk
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.scene import build_scene

    name, args = ("cornell_box", ()) if engine == "mega" else ("boxfield",
                                                              (60,))
    loaded, camcfg = getattr(scenes, name)(*args)
    scene, lights = build_scene(loaded, device="cpu")
    cam = make_camera(dataclasses.replace(camcfg, resolution=(W, H)),
                      device="cpu")
    kw = ENGINE_KW[engine]
    if engine == "mega":
        return mk.render_mega(mk.build_megascene(scene, lights), cam, W, H,
                              spp=SPP, **kw)
    cms = cmk.build_cluster_megascene(scene, lights)
    fn = cmk.render_hybrid if engine == "hybrid" else cmk.render_cluster_mega
    return fn(cms, cam, W, H, SPP, **kw)


@pytest.mark.parametrize("tag", list(MESHES))
def test_mesh_coordinates(world, tag):
    """Rank si·P + pi of the mesh's ranks holds (si, pi); the others none."""
    ranks, _ = world
    s, p, members = MESHES[tag]
    members = list(range(8)) if members is None else members
    want = np.full((8, 2), -1)
    for i, r in enumerate(members):
        want[r] = divmod(i, p)
    np.testing.assert_array_equal(ranks[0]["coords/" + tag], want)


def test_mesh_refusals(world):
    """A samples axis that does not divide the world, and a render on a rank
    outside the mesh, raise."""
    ranks, _ = world
    assert all(ranks[r]["bad_shape_raises"] == 1 for r in range(8))
    assert ranks[6]["outside_raises"] == 1 and ranks[7]["outside_raises"] == 1


@pytest.mark.parametrize("engine", ["mega", "cluster", "hybrid"])
def test_kernel_engines_sharded_equal_one_device(world, engine):
    """Every mesh shape, every member rank: the one-device sum to rtol 1e-5,
    the one-device segment count exactly (the padded tail renders nothing
    twice)."""
    ranks, _ = world
    rad, segs = _one_device(engine)
    for tag, (_, _, members) in MESHES.items():
        for r in (range(8) if members is None else members):
            got = ranks[r][f"{engine}/{tag}"]
            assert got.shape == (W * H, 3)
            np.testing.assert_allclose(got, rad.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{tag} rank {r}")
            assert float(ranks[r][f"{engine}/{tag}/segs"]) == float(segs)


@pytest.mark.parametrize("engine", ["mega", "cluster", "hybrid"])
def test_mesh_shape_invariance(world, engine):
    ranks, _ = world
    first = ranks[0][f"{engine}/1x8"]
    assert first.sum() > 0.0
    for tag in MESHES:
        np.testing.assert_allclose(ranks[0][f"{engine}/{tag}"], first,
                                   rtol=1e-5, atol=1e-6, err_msg=tag)


def test_hybrid_row_order_built_once_per_pixels_extent(world):
    """After each mesh's engine runs, a member rank has built the sharded
    hybrid's row order once for every distinct ``pixels`` extent it has
    rendered, and never again for an extent it had."""
    ranks, _ = world
    for r in range(8):
        seen = set()
        for tag, (_, p, members) in MESHES.items():
            if members is not None and r not in members:
                continue
            seen.add(p)
            assert int(ranks[r]["rows_misses/" + tag]) == len(seen), \
                f"{tag} rank {r}"


def test_furnace_exact_through_sharded_wavefront(world):
    """The zero-variance furnace on the (2,3) mesh, whose last slice is
    padded: sphere 0.5, background 1.0 (``test_dist``'s check)."""
    ranks, _ = world
    img = ranks[0]["furnace"].reshape(H, W, 3) / 4.0
    np.testing.assert_allclose(img[H // 2, W // 2], 0.5, atol=1e-5)
    np.testing.assert_allclose(img[1, 1], 1.0, atol=1e-5)
    for r in range(1, 6):
        np.testing.assert_array_equal(ranks[r]["furnace"], ranks[0]["furnace"])


@pytest.mark.parametrize("tag", WAVEFRONT_MESHES)
def test_sharded_wavefront_matches_mcpt(world, tag):
    """Same key, same mesh shape: the port's threefry draws ``mcpt``'s bits,
    so the sharded wavefronts agree under the dense gate."""
    ranks, mcpt_out = world
    assert_parity(ranks[0]["wavefront/" + tag], mcpt_out[tag],
                  float(ranks[0]["wavefront/" + tag + "/segs"]),
                  float(mcpt_out[tag + "/segs"]))


def test_sharded_wavefront_deterministic(world):
    ranks, _ = world
    a, b = ranks[0]["repeat"]
    np.testing.assert_array_equal(a, b)


def test_hybrid_sharded_with_compaction_is_finite(world):
    """Each shard compacts its own pool: finite, positive, and the
    segment count stays a number (a live ray dropped would make it NaN)."""
    ranks, _ = world
    rad = ranks[0]["compact"]
    assert rad.shape == (W * H, 3) and np.isfinite(rad).all()
    assert rad.sum() > 0.0 and np.isfinite(float(ranks[0]["compact/segs"]))


def test_render_sharded_accumulates(world):
    """30 spp on a samples axis of 4 rounds up to 32, in 8-spp steps; the
    mean agrees with one device's wavefront within 5% (mcpt's check)."""
    from mcpt_torch import scenes
    from mcpt_torch.render import integrator as integ
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.scene import build_scene
    import dataclasses

    ranks, _ = world
    assert (ranks[0]["progressive/count"] == 32).all()
    loaded, camcfg = scenes.quad_light_plane()
    scene, lights = build_scene(loaded, device="cpu")
    cam = make_camera(dataclasses.replace(camcfg, resolution=(W, H)),
                      device="cpu")
    opts = integ.RenderOptions(max_depth=3, method="brute", nee=True,
                               mis=True)
    fb = integ.render(scene, lights, cam, W, H, opts, spp=32, seed=1,
                      spp_per_step=32)
    m_1 = float(fb.mean.mean())
    assert abs(ranks[0]["progressive/mean"].mean() - m_1) < 0.05 * m_1


def test_backend_for():
    """gloo on the CPU and whenever ranks outnumber the cards."""
    assert dist.backend_for("cpu", 1) == "gloo"
    assert dist.backend_for("cuda", torch.cuda.device_count() + 1) == "gloo"


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        dist.make_mesh(samples=1)


def _mesh_config(tmp_path, **mesh):
    from mcpt_torch.config import write_config_variant

    return write_config_variant(os.path.join(ROOT, "config.json"), 9,
                                str(tmp_path / "c9.json"), mesh=mesh)


def test_cli_several_ranks_need_a_mesh(tmp_path, monkeypatch):
    """Under torchrun (WORLD_SIZE > 1) a config without ``mesh`` raises
    before any rank joins; with ``mesh`` and ``--device cuda`` and no card
    the world is not joined either."""
    from mcpt_torch.config import write_config_variant

    monkeypatch.setenv("WORLD_SIZE", "2")
    plain = write_config_variant(os.path.join(ROOT, "config.json"), 2,
                                 str(tmp_path / "c2.json"))
    with pytest.raises(ValueError, match="no 'mesh'"):
        render_cli.main(["--config", plain, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            render_cli.main(["--config", _mesh_config(tmp_path, samples=2),
                             "--device", "cuda"])


def test_cli_mesh_config_under_torchrun(tmp_path):
    """Config 9 (diningroom, the hybrid) with mesh {"samples": 2} at 16×8,
    8 spp in two steps, under ``torchrun`` with 2 gloo ranks: rank 0 prints
    the mesh and backend and writes the files, and the checkpoint's sum
    equals the one-process render's to rtol 1e-5 (same steps, same seeds,
    no pilot on the CPU)."""
    config = _mesh_config(tmp_path, samples=2)
    common = ["--config", config, "--width", "16", "--height", "8", "--spp",
              "8", "--device", "cpu", "--checkpoint-every", "8"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "mcpt_torch.render_cli", *common,
         "--out", str(tmp_path / "sharded")],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300,
        check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert ("mesh: {'samples': 2, 'pixels': 1} over 2 ranks | backend gloo"
            in proc.stdout)
    assert proc.stdout.count("Finished Attempting") == 1
    assert render_cli.main([*common, "--out", str(tmp_path / "one")]) == 0
    a = np.load(tmp_path / "sharded" / "diningroom.ckpt.npz")
    b = np.load(tmp_path / "one" / "diningroom.ckpt.npz")
    assert int(a["done"]) == int(b["done"]) == 8
    np.testing.assert_array_equal(a["count"], b["count"])
    np.testing.assert_allclose(a["sum"], b["sum"], rtol=1e-5, atol=1e-6)
    assert (tmp_path / "sharded" / "diningroom.exr").stat().st_size
