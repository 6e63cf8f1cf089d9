"""The port's CUDA kernels on the card against their plain PyTorch versions.

Marked ``gpu``: without a CUDA device every test here skips (the kernels have
no CPU mode; their arithmetic is tested on the CPU through the plain version).
On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import collections
import dataclasses
import math

import pytest
import torch

from mcpt_torch import scenes
from mcpt_torch.kernels import _build
from mcpt_torch.kernels import megakernel as mk
from mcpt_torch.render.camera import make_camera
from mcpt_torch.scene import build_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(name, w, h, device, **scene_kw):
    loaded, camcfg = getattr(scenes, name)(**scene_kw)
    scene, lights = build_scene(loaded, device=device)
    cam = make_camera(dataclasses.replace(camcfg, resolution=(w, h)),
                      device=device)
    return mk.build_megascene(scene, lights), cam


@pytest.mark.parametrize("name,depth", [("cornell_box", 16),
                                        ("veach_mis", 8),
                                        ("furnace_sphere", 8)])
@pytest.mark.parametrize("schedule", ["regen", "batch"])
def test_kernel_matches_plain_version(cuda, name, depth, schedule):
    """Built with -fmad=false, the kernel rounds as PyTorch's elementwise
    kernels do: the same bits on the same streams."""
    mega, cam = _setup(name, 24, 16, cuda)
    kw = dict(spp=3, seed=2, max_depth=depth, rr=True, nee=True, mis=True,
              schedule=schedule)
    before = _build.LAUNCHES["mcpt_render_mega"]
    a, sa = mk.render_mega(mega, cam, 24, 16, **kw)
    assert _build.LAUNCHES["mcpt_render_mega"] == before + 1
    b, sb = mk.render_mega_reference(mega, cam, 24, 16, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(sa) == float(sb)


def test_kernel_reads_large_tables_from_global_memory(cuda):
    """5440 triangle rows (371 KB of tables) exceed a block's 227 KB of
    shared memory: the kernel reads the tables from global memory, gives
    the plain version's bits, and the furnace identity still holds."""
    mega, cam = _setup("furnace_sphere", 16, 16, cuda, subdiv=4)
    rows = (mega.tri.shape[0], mega.matt.shape[0], mega.lit.shape[0],
            mega.cbox.shape[0])
    assert rows[0] == 5440 and mk.table_home(*rows) == "global"
    for kw in (dict(nee=True, mis=True), {}):
        before = mk.HOMES["global"]
        a, sa = mk.render_mega(mega, cam, 16, 16, spp=4, seed=3, max_depth=6,
                               **kw)
        assert mk.HOMES["global"] == before + 1
        b, sb = mk.render_mega_reference(mega, cam, 16, 16, spp=4, seed=3,
                                         max_depth=6, **kw)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert float(sa) == float(sb)
    img = a.reshape(16, 16, 3) / 4.0  # BSDF sampling alone: exact
    torch.testing.assert_close(img[8, 8], torch.full_like(img[8, 8], 0.5),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(img[0, 0], torch.ones_like(img[0, 0]),
                               rtol=0, atol=1e-5)


def _same_bits(mega, cam, w, h, **kw):
    """The kernel's output equals the plain version's, bit for bit."""
    a, sa = mk.render_mega(mega, cam, w, h, **kw)
    b, sb = mk.render_mega_reference(mega, cam, w, h, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(sa) == float(sb)
    return a, sa


@pytest.mark.parametrize("name,depth", [("cornell_box", 8),
                                        ("veach_mis", 6)])
@pytest.mark.parametrize("schedule", ["regen", "batch"])
def test_kernel_on_a_ragged_pixel_count(cuda, name, depth, schedule):
    """23x17 = 391 pixels, a multiple of neither a warp nor a block nor the
    8x4 tiles: the last warp and the edge tiles are partial, in both tiers
    and both schedules."""
    mega, cam = _setup(name, 23, 17, cuda)
    _same_bits(mega, cam, 23, 17, spp=3, seed=4, max_depth=depth, rr=True,
               nee=True, mis=True, schedule=schedule)


def test_kernel_twice_in_a_row(cuda):
    """A second launch of the same step renders every lane again, with the
    same bits."""
    mega, cam = _setup("veach_mis", 24, 16, cuda)
    kw = dict(spp=2, seed=8, max_depth=6, nee=True, mis=True)
    a1, s1 = mk.render_mega(mega, cam, 24, 16, **kw)
    a2, s2 = _same_bits(mega, cam, 24, 16, **kw)
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    assert float(s1) == float(s2)


@pytest.mark.parametrize("schedule", ["regen", "batch"])
def test_kernel_on_a_pixel_range(cuda, schedule):
    """pixel_base and pixel_count: pixels [37, 138) of a 24x16 view, each
    with its own (sample, pixel) RNG counter, so they equal those rows of
    the whole view's render."""
    mega, cam = _setup("cornell_box", 24, 16, cuda)
    kw = dict(spp=2, seed=5, max_depth=6, rr=True, nee=True, mis=True,
              schedule=schedule)
    part, _ = _same_bits(mega, cam, 24, 16, pixel_base=37, pixel_count=101,
                         **kw)
    whole, _ = mk.render_mega(mega, cam, 24, 16, **kw)
    torch.testing.assert_close(part, whole[37:138], rtol=0, atol=0)


@pytest.mark.parametrize("schedule", ["regen", "batch"])
def test_kernel_on_a_mid_tile_slice_and_the_tail(cuda, schedule):
    """The sharded engine's slices on a ragged 23x17 view: one that starts
    mid-row and mid 8x4 tile (pixel 118 = row 5, column 3) and the tail
    slice that ends at the last pixel, each with a sample base; the plain
    version's bits, which are the whole view's rows at those samples.  A
    slice past the last pixel is refused (the sharded engine gives the last
    shard its true count)."""
    mega, cam = _setup("cornell_box", 23, 17, cuda)
    kw = dict(seed=5, max_depth=6, rr=True, nee=True, mis=True,
              schedule=schedule)
    whole, _ = mk.render_mega(mega, cam, 23, 17, spp=4, **kw)
    parts = []
    for base, count in ((0, 118), (118, 150), (268, 391 - 268)):
        for sb in (0, 2):
            part, _ = _same_bits(mega, cam, 23, 17, spp=2, pixel_base=base,
                                 pixel_count=count, sample_base=sb, **kw)
            parts.append(part)
    halves = [parts[i] + parts[i + 1] for i in range(0, 6, 2)]
    torch.testing.assert_close(torch.cat(halves), whole, rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(RuntimeError, match="launch failed"):
        mk.render_mega(mega, cam, 23, 17, spp=2, pixel_base=268,
                       pixel_count=124, **kw)


@pytest.mark.parametrize("n_boxes,home", [(383, "shared"), (384, "global")])
def test_kernel_reads_each_table_home(cuda, n_boxes, home):
    """boxfield(383)'s tables fill 231,360 of the 232,372 bytes a block may
    hold beside the sf table; boxfield(384)'s 232,416 bytes, just past
    them, stay in global memory.  Each launch goes where the wrapper's rule
    sends it and gives the plain version's bits."""
    mega, cam = _setup("boxfield", 16, 12, cuda, n_boxes=n_boxes)
    rows = (mega.tri.shape[0], mega.matt.shape[0], mega.lit.shape[0],
            mega.cbox.shape[0])
    assert mk.table_home(*rows) == home
    before = mk.HOMES[home]
    _same_bits(mega, cam, 16, 12, spp=2, seed=6, max_depth=4, rr=True,
               nee=True, mis=True)
    assert mk.HOMES[home] == before + 1


@pytest.mark.parametrize("name", ["cornell_box", "veach_mis"])
def test_kernel_keeps_the_lower_row_of_a_tie(cuda, name):
    """Every triangle twice: the table followed by a copy of itself with
    the next material, so each row ties exactly with a twin in a later row
    (in the chunked tier, a later chunk with the same box).  The first row
    of a tie wins, so the doubled table renders the original's bits."""
    mega, cam = _setup(name, 24, 16, cuda)
    twin = mega.tri.clone()
    twin[:, 15] = (twin[:, 15] + 1) % mega.n_mats
    n_rows = mega.tri.shape[0]
    doubled = mega._replace(
        tri=torch.cat([mega.tri, twin]).contiguous(),
        cbox=(torch.cat([mega.cbox, mega.cbox]).contiguous()
              if mk.tier(mega.n_tris) == "chunked" else mega.cbox),
        n_tris=n_rows + mega.n_tris)
    assert mk.tier(doubled.n_tris) == mk.tier(mega.n_tris)
    kw = dict(spp=2, seed=9, max_depth=6, nee=True, mis=True)
    a, sa = _same_bits(doubled, cam, 24, 16, **kw)
    b, sb = mk.render_mega(mega, cam, 24, 16, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(sa) == float(sb)


def test_kernel_fills_the_sm(cuda):
    """__launch_bounds__ holds kernel 1 to the registers that keep 20 warps
    an SM resident at the repo's small scenes (cbox, veach_mis)."""
    lib = _build.load()
    threads = lib.mcpt_render_mega_block_threads()
    for name in ("cornell_box", "veach_mis"):
        mega, _ = _setup(name, 8, 8, cuda)
        rows = (mega.tri.shape[0], mega.matt.shape[0], mega.lit.shape[0],
                mega.cbox.shape[0])
        blocks = lib.mcpt_render_mega_blocks_per_sm(
            *rows, int(mk.tier(mega.n_tris) == "chunked"),
            mk._HOME_CODES[mk.table_home(*rows)])
        assert blocks * threads // 32 >= 20, (name, blocks, threads)


def test_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    mega, cam = _setup("quad_light_plane", 8, 8, cuda)
    with pytest.raises(ValueError, match="float32"):
        mk.render_mega(mega._replace(tri=mega.tri.double()), cam, 8, 8,
                       spp=1, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        mk.render_mega(mega._replace(tri=mega.tri.t().contiguous().t()), cam,
                       8, 8, spp=1, seed=0)
    cpu_cam = cam._replace(position=cam.position.cpu())
    with pytest.raises((ValueError, RuntimeError)):
        mk.render_mega(mega, cpu_cam, 8, 8, spp=1, seed=0)


# --------------------------------------------------------------------------
# the hybrid engine's fused-bounce kernel (csrc/fused_bounce.cu)
# --------------------------------------------------------------------------


def _hybrid_setup(device, w=32, h=24, spp=2, seed=6):
    from mcpt_torch.kernels import cluster_megakernel as cmk

    loaded, camcfg = scenes.boxfield(60)
    scene, lights = build_scene(loaded, device=device)
    cam = make_camera(dataclasses.replace(camcfg, resolution=(w, h)),
                      device=device)
    cms = cmk.build_cluster_megascene(scene, lights)
    state, rid = cmk.camera_pool(cms, cam, w, h, spp, seed, n_pool=4096)
    return cmk, cms, cam, state, rid


def test_fused_bounce_matches_plain_version(cuda):
    """Depths 0-3 on boxfield(60), NEE+MIS+RR, each from the kernel's own
    previous output: radiance, alive and segments bit-equal on every lane,
    and every plane of the lanes still alive."""
    cmk, cms, _, state, rid = _hybrid_setup(cuda)
    kw = dict(max_depth=4, rr=True, rr_start=1, nee=True, mis=True)
    for depth in range(4):
        a, b = state.clone(), state.clone()
        before = _build.LAUNCHES["mcpt_fused_bounce"]
        sa = cmk.fused_bounce(cms, a, rid, 6, depth, **kw)
        assert _build.LAUNCHES["mcpt_fused_bounce"] == before + 1
        sb = cmk.fused_bounce_reference(cms, b, rid, 6, depth, **kw)
        assert torch.equal(sa, sb), depth
        for plane in range(9, 13):
            assert torch.equal(a[plane], b[plane]), (depth, plane)
        live = a[cmk.ALIVE] > 0
        assert torch.equal(a[:, live], b[:, live]), depth
        state = a


def test_render_hybrid_kernel_matches_plain_pipeline(cuda):
    """Kernel 2 and the between-bounce kernels together against the
    all-plain pipeline (plain bounce, plain stages), bit for bit.  At 8 spp
    the pool (8192 lanes) shrinks to 4096 after bounce 0, through the
    roulette kernels and a tail: one raygen call a render, one roulette
    call a shrink, one key and one reorder call a re-sort; the plain
    pipeline calls none."""
    cmk, cms, cam, _, _ = _hybrid_setup(cuda)
    for spp, kw in ((4, dict(key_mode="cell")),
                    (8, dict(key_mode="dir6", compact=(0.5, 0.3, 0.3)))):
        kw = dict(kw, spp=spp, seed=2, max_depth=4, nee=True, mis=True,
                  rr=True, rr_start=1)
        rows0 = -(-spp * 32 * 24 // cmk.BLKT) * cmk.SUBT
        rows = cmk._compaction_schedule(rows0, 4, kw.get("compact"))
        shrinks = sum(b < a for a, b in zip(rows, rows[1:]))
        assert shrinks == (1 if "compact" in kw else 0)
        before = _build.LAUNCHES.copy()
        want = collections.Counter(
            mcpt_hybrid_raygen=1, mcpt_fused_bounce=4,
            mcpt_hybrid_roulette=shrinks, mcpt_hybrid_sort_key=3,
            mcpt_hybrid_reorder=3)
        a, sa = cmk.render_hybrid(cms, cam, 32, 24, **kw)
        assert _build.LAUNCHES - before == want
        b, sb = cmk.render_hybrid_reference(cms, cam, 32, 24, **kw)
        assert _build.LAUNCHES - before == want
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert float(sa) == float(sb)


def test_render_hybrid_kernel_on_a_pixel_subset(cuda):
    """The sharded hybrid's call: a slice of the tile order (starting
    mid-tile) at a sample base, through the kernel and through the plain
    pipeline, bit for bit, in ascending pixel id order."""
    cmk, cms, cam, _, _ = _hybrid_setup(cuda)
    perm = cmk.tile_pixels(32, 24, cuda)[0][100:500]
    for kw in (dict(key_mode="cell"),
               dict(key_mode="dir6", compact=(0.5, 0.3, 0.3))):
        kw = dict(kw, spp=2, seed=2, max_depth=4, nee=True, mis=True,
                  rr=True, rr_start=1, perm=perm, sample_base=3)
        a, sa = cmk.render_hybrid(cms, cam, 32, 24, **kw)
        b, sb = cmk.render_hybrid_reference(cms, cam, 32, 24, **kw)
        assert a.shape == (400, 3) and float(a.sum()) > 0.0
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert float(sa) == float(sb)


def test_fused_bounce_stack_overflow_raises(cuda):
    """A (cyclic) wide node whose 8 always-hit children are itself pushes
    past STACK_CAP: the kernel sets its flag and the wrapper raises."""
    cmk, cms, _, state, rid = _hybrid_setup(cuda)
    row = torch.zeros(64, dtype=torch.float32)
    for k in range(8):
        row[6 * k: 6 * k + 3] = -1e30
        row[6 * k + 3: 6 * k + 6] = 1e30
    row[56:64] = float(sum(k << (3 * k) for k in range(8)))
    bad = cms._replace(wnodes=row[None].to(cuda))
    with pytest.raises(RuntimeError, match="stack overflow"):
        cmk.fused_bounce(bad, state.clone(), rid, 0, 0)


def test_render_hybrid_stack_overflow_raises_from_the_call(cuda):
    """The cyclic table above through ``render_hybrid``: kernel 2's flag is
    read once, at the step's end, so every bounce runs; the call raises
    "stack overflow" and leaves no deferred block open; a healthy render
    after it runs clean."""
    cmk, cms, cam, _, _ = _hybrid_setup(cuda)
    bad = _cyclic_clusters(cms, cuda)
    before = _build.LAUNCHES["mcpt_fused_bounce"]
    with pytest.raises(RuntimeError, match="stack overflow"):
        cmk.render_hybrid(bad, cam, 32, 24, spp=2, seed=4, max_depth=4)
    assert _build.LAUNCHES["mcpt_fused_bounce"] == before + 4
    assert _build._DEFERRED is None
    rad, segs = cmk.render_hybrid(cms, cam, 32, 24, spp=2, seed=4,
                                  max_depth=4)
    assert bool(torch.isfinite(rad).all()) and math.isfinite(float(segs))


def test_fused_bounce_wrapper_refusals(cuda):
    cmk, cms, _, state, rid = _hybrid_setup(cuda)
    with pytest.raises(ValueError, match="float32"):
        cmk.fused_bounce(cms, state.double(), rid, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        cmk.fused_bounce(cms, state.t().contiguous().t(), rid, 0, 0)
    with pytest.raises(ValueError, match="rid"):
        cmk.fused_bounce(cms, state, rid.long(), 0, 0)
    with pytest.raises(ValueError, match="rid"):
        cmk.fused_bounce(cms, state, rid.cpu(), 0, 0)
    with pytest.raises(ValueError, match=r"\(16, N\)"):
        cmk.fused_bounce(cms, state[:15].contiguous(), rid, 0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        cmk.fused_bounce(cms._replace(tri16=cms.tri16.cpu()), state, rid, 0,
                         0)


# --------------------------------------------------------------------------
# the hybrid's between-bounce kernels (csrc/hybrid_stage.cu)
# --------------------------------------------------------------------------


def _stage_pool(device, n=4480, dead=0.4, seed=3):
    """A (16, n) pool of random planes, ``dead`` of its lanes dead, origins
    partly outside boxfield-like bounds, unit directions with the axes and
    a zero among them; rids over the whole int32 range."""
    g = torch.Generator().manual_seed(seed)
    state = torch.rand((16, n), generator=g) * 4.0 - 2.0
    state[0:3] = torch.rand((3, n), generator=g) * 24.0 - 12.0
    d = torch.randn((3, n), generator=g)
    d = d / d.norm(dim=0)
    d[:, :7] = torch.tensor([[1.0, -1, 0, 0, 0, 0, 0], [0, 0, 1, -1, 0, 0, 0],
                             [0, 0, 0, 0, 1, -1, 0]])
    state[3:6] = d
    state[6:9] = torch.rand((3, n), generator=g) + 0.5
    state[12] = (torch.rand(n, generator=g) >= dead).float()
    rid = torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                        dtype=torch.int32)
    return state.to(device), rid.to(device)


@pytest.mark.parametrize("case", ["p<1", "p=1", "all dead"])
def test_roulette_kernel_matches_plain_version(cuda, case):
    from mcpt_torch.kernels import cluster_megakernel as cmk

    state, rid = _stage_pool(cuda, dead=1.0 if case == "all dead" else 0.4)
    live = int((state[cmk.ALIVE] > 0).sum())
    cap = {"p<1": 0.3 * live, "p=1": 2.0 * live, "all dead": 100.0}[case]
    a, b = state.clone(), state.clone()
    before = _build.LAUNCHES["mcpt_hybrid_roulette"]
    cmk.roulette(a, rid, 2**33 + 5, 3, cap)
    assert _build.LAUNCHES["mcpt_hybrid_roulette"] == before + 1
    cmk._roulette(b, rid, 2**33 + 5, 3, cap)
    assert torch.equal(a, b)
    kept = int((a[cmk.ALIVE] > 0).sum())
    if case == "p<1":
        assert 0 < kept < live and not torch.equal(a[6:9], state[6:9])
    else:
        assert kept == live and torch.equal(a[6:9], state[6:9])


@pytest.mark.parametrize("mode", ["cell", "dir", "dir6", "dir9"])
def test_sort_key_kernel_matches_plain_version(cuda, mode):
    from mcpt_torch.kernels import cluster_megakernel as cmk

    state, _ = _stage_pool(cuda)
    lo, inv = (-10.0, -9.0, -8.0), (0.05, 0.06, 0.07)
    before = _build.LAUNCHES["mcpt_hybrid_sort_key"]
    got = cmk.sort_key(*state[:6], state[cmk.ALIVE], lo, inv, mode)
    assert _build.LAUNCHES["mcpt_hybrid_sort_key"] == before + 1
    want = cmk._hybrid_sort_key(*state[:6], state[cmk.ALIVE], lo, inv, mode)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    dead = state[cmk.ALIVE] == 0
    assert bool((got[dead] == cmk.DEAD_KEY).all())


@pytest.mark.parametrize("keep", [4480, 2560, 128])
def test_reorder_kernel_matches_plain_version(cuda, keep):
    """Most keys DEAD_KEY (ties the stable sort keeps in lane order), with
    and without a shrink; at 128 kept lanes live ones fall in the tail and
    both versions set the NaN canary."""
    from mcpt_torch.kernels import cluster_megakernel as cmk

    state, rid = _stage_pool(cuda, dead=0.7)
    lo, inv = (-10.0, -9.0, -8.0), (0.05, 0.06, 0.07)
    key = cmk._hybrid_sort_key(*state[:6], state[cmk.ALIVE], lo, inv, "cell")
    order = torch.sort(key, stable=True).indices
    total = torch.full((), 12345.0, dtype=torch.float64, device=cuda)
    before = _build.LAUNCHES["mcpt_hybrid_reorder"]
    a = cmk.reorder(state, rid, order, keep, total.clone())
    assert _build.LAUNCHES["mcpt_hybrid_reorder"] == before + 1
    b = cmk._reorder_reference(state, rid, order, keep, total.clone())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].shape == (16, keep) and a[1].shape == (keep,)
    if keep == state.shape[1]:
        assert a[2] is None and b[2] is None
    else:
        assert torch.equal(a[2][0], b[2][0]) and torch.equal(a[2][1], b[2][1])
    live = int((state[cmk.ALIVE] > 0).sum())
    if keep < live:
        assert math.isnan(float(a[3])) and math.isnan(float(b[3]))
    else:
        assert float(a[3]) == float(b[3]) == 12345.0


def test_hybrid_stage_wrapper_refusals(cuda):
    from mcpt_torch.kernels import cluster_megakernel as cmk

    state, rid = _stage_pool(cuda)
    lo, inv = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="float32"):
        cmk.roulette(state.double(), rid, 0, 0, 10.0)
    with pytest.raises(ValueError, match="contiguous"):
        cmk.roulette(state.t().contiguous().t(), rid, 0, 0, 10.0)
    with pytest.raises(ValueError, match="rid"):
        cmk.roulette(state, rid.long(), 0, 0, 10.0)
    with pytest.raises(ValueError, match="rid"):
        cmk.roulette(state, rid.cpu(), 0, 0, 10.0)
    with pytest.raises(ValueError, match=r"\(16, N\)"):
        cmk.roulette(state[:15].contiguous(), rid, 0, 0, 10.0)
    planes = list(state[:6]) + [state[cmk.ALIVE]]
    with pytest.raises(ValueError, match="float32"):
        cmk.sort_key(*planes[:6], planes[6].double(), lo, inv)
    with pytest.raises(ValueError, match="CUDA"):
        cmk.sort_key(*planes[:6], planes[6].cpu(), lo, inv)
    with pytest.raises(ValueError, match="contiguous"):
        cmk.sort_key(*planes[:5], state[:, 5], planes[6], lo, inv)
    with pytest.raises(ValueError, match="length"):
        cmk.sort_key(*planes[:6], planes[6][:128], lo, inv)
    with pytest.raises(ValueError, match="key_mode"):
        cmk.sort_key(*planes, lo, inv, "octant")
    n = state.shape[1]
    order = torch.arange(n, device=cuda)
    total = torch.zeros((), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="order"):
        cmk.reorder(state, rid, order.int(), n, total)
    with pytest.raises(ValueError, match="order"):
        cmk.reorder(state, rid, order[:-1], n, total)
    with pytest.raises(ValueError, match="keep"):
        cmk.reorder(state, rid, order, 0, total)
    with pytest.raises(ValueError, match="keep"):
        cmk.reorder(state, rid, order, n + 1, total)
    with pytest.raises(ValueError, match="segs_total"):
        cmk.reorder(state, rid, order, n, total.float())
    with pytest.raises(ValueError, match="rid"):
        cmk.reorder(state, rid[:-1], order, n, total)


def _host_copies(fn):
    """fn() inside ``mcpt.hybrid.raygen`` under ``torch.profiler`` over the
    host and the card → (its result, the names of every event)."""
    from torch.profiler import ProfilerActivity, profile

    from mcpt_torch.trace import span

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("mcpt.hybrid.raygen"):
            out = fn()
    torch.cuda.synchronize()
    return out, [e.name for e in prof.events()]


@pytest.mark.parametrize("case", ["tile order", "shard"])
@pytest.mark.parametrize("spp", [1, 3])
def test_camera_pool_kernel_matches_plain_version(cuda, case, spp):
    """The raygen kernel against ``camera_pool_reference`` on boxfield(60),
    every plane and every id bit for bit, pad lanes included (the pool
    holds more lanes than rays): the whole tile order at sample base 0, and
    a shard's slice of it (starting mid-tile) at a sample base whose ids
    pass 2³¹, so both the stream counter and the int32 id wrap.  One call
    is one launch; under the profiler it copies nothing between host and
    card, waits on nothing and opens no ``mcpt.wait.sf``, where the plain
    version does all three."""
    w, h = 96, 40  # past 64 pixels wide the tile order is no identity
    cmk, cms, cam, _, _ = _hybrid_setup(cuda, w, h, spp=1)
    if case == "tile order":
        perm, base, n_px = None, 0, w * h
    else:
        perm, base = cmk.tile_pixels(w, h, cuda)[0][1000:2500], 2**22 + 3
        n_px = 1500
        assert (base + spp) * w * h > 2**31
    n_rays = n_px * spp
    n_pool = -(-n_rays // cmk.BLKT) * cmk.BLKT
    assert n_pool > n_rays
    args = (cms, cam, w, h, spp, 2**33 + 7, n_pool, perm, base)
    before = _build.LAUNCHES["mcpt_hybrid_raygen"]
    (state, rid), names = _host_copies(lambda: cmk.camera_pool(*args))
    assert _build.LAUNCHES["mcpt_hybrid_raygen"] == before + 1
    with _build.plain_versions():
        (want, want_rid), plain_names = _host_copies(
            lambda: cmk.camera_pool(*args))
    assert _build.LAUNCHES["mcpt_hybrid_raygen"] == before + 1
    assert state.shape == want.shape == (16, n_pool)
    assert rid.dtype == want_rid.dtype == torch.int32
    for plane in range(16):
        assert torch.equal(state[plane], want[plane]), plane
    assert torch.equal(rid, want_rid)
    assert float(state[cmk.ALIVE].sum()) == n_rays
    if case == "shard":
        assert bool((rid < 0).any())
    busy = [n for n in names if "Memcpy" in n or "StreamSynchronize" in n
            or n in ("aten::_local_scalar_dense", "mcpt.wait.sf")]
    assert busy == [] and "mcpt.hybrid.raygen" in names
    assert any("Memcpy DtoH" in n for n in plain_names)
    assert "mcpt.wait.sf" in plain_names


def test_camera_pool_wrapper_refusals(cuda):
    cmk, cms, cam, _, _ = _hybrid_setup(cuda)
    perm = cmk.tile_pixels(32, 24, cuda)[0]
    cpu_cam = cam._replace(**{f: getattr(cam, f).cpu() for f in cam._fields})
    with pytest.raises(ValueError, match="camera on cpu"):
        cmk.camera_pool(cms, cpu_cam, 32, 24, 1, 0, 4096)
    with pytest.raises(ValueError, match="perm"):
        cmk.camera_pool(cms, cam, 32, 24, 1, 0, 4096, perm.cpu())
    with pytest.raises(ValueError, match="perm"):
        cmk.camera_pool(cms, cam, 32, 24, 1, 0, 4096, perm[None])
    with pytest.raises(ValueError, match="n_pool"):
        cmk.camera_pool(cms, cam, 32, 24, 8, 0, 4096)


# --------------------------------------------------------------------------
# the cluster megakernel (csrc/cluster_mega.cu) and the wavefront's cluster
# traversal (csrc/traverse.cu)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["regen", "batch"])
def test_cluster_mega_matches_plain_version(cuda, schedule):
    """Whole paths through the cluster walk on boxfield(60), NEE+MIS+RR:
    the plain version's bits, one launch."""
    cmk, cms, cam, _, _ = _hybrid_setup(cuda)
    kw = dict(spp=3, seed=4, max_depth=4, nee=True, mis=True, rr=True,
              rr_start=1, schedule=schedule)
    before = _build.LAUNCHES["mcpt_render_cluster"]
    a, sa = cmk.render_cluster_mega(cms, cam, 32, 24, **kw)
    assert _build.LAUNCHES["mcpt_render_cluster"] == before + 1
    b, sb = cmk.render_cluster_mega_reference(cms, cam, 32, 24, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(sa) == float(sb)


@pytest.mark.parametrize("schedule", ["regen", "batch"])
def test_cluster_mega_on_a_pixel_subset(cuda, schedule):
    """The sharded cluster engine's call: 300 pixels of the tile order from
    position 77 at sample base 5, through kernel 3 and its plain version,
    bit for bit, rows in the subset's order."""
    cmk, cms, cam, _, _ = _hybrid_setup(cuda, w=37, h=23)
    pix = cmk.tile_pixels(37, 23, cuda)[0][77:377]
    kw = dict(spp=3, seed=9, max_depth=4, nee=True, mis=True, rr=True,
              rr_start=1, schedule=schedule, pix=pix, sample_base=5)
    before = _build.LAUNCHES["mcpt_render_cluster"]
    a, sa = cmk.render_cluster_mega(cms, cam, 37, 23, **kw)
    assert _build.LAUNCHES["mcpt_render_cluster"] == before + 1
    b, sb = cmk.render_cluster_mega_reference(cms, cam, 37, 23, **kw)
    assert a.shape == (300, 3) and float(a.sum()) > 0.0
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(sa) == float(sb)


@pytest.mark.parametrize("schedule", ["regen", "batch"])
def test_cluster_mega_persistent_warps_on_a_ragged_pixel_count(cuda,
                                                               schedule):
    """37x23 = 851 pixels, a multiple neither of a warp nor of a block: the
    persistent warps hand out every lane exactly once and give the plain
    version's bits; a second launch right after the first (the lane counter
    zeroed again) gives the same bits."""
    cmk, cms, cam, _, _ = _hybrid_setup(cuda, w=37, h=23)
    kw = dict(spp=3, seed=9, max_depth=4, nee=True, mis=True, rr=True,
              rr_start=1, schedule=schedule)
    a, sa = cmk.render_cluster_mega(cms, cam, 37, 23, **kw)
    a2, sa2 = cmk.render_cluster_mega(cms, cam, 37, 23, **kw)
    b, sb = cmk.render_cluster_mega_reference(cms, cam, 37, 23, **kw)
    assert torch.equal(a, a2) and float(sa) == float(sa2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(sa) == float(sb) and float(a.sum()) > 0.0


def test_fused_bounce_live_lanes_ending_mid_warp(cuda):
    """A sorted pool whose live lanes end at lane 1013, inside a warp: the
    persistent threads bounce every live lane as the plain version does,
    pass the dead ones through with 0 segments, and a second launch on the
    same input gives the same bits."""
    cmk, cms, _, state, rid = _hybrid_setup(cuda)
    state[cmk.ALIVE, 1013:] = 0.0
    kw = dict(max_depth=4, rr=True, rr_start=1, nee=True, mis=True)
    a, a2, b = state.clone(), state.clone(), state.clone()
    sa = cmk.fused_bounce(cms, a, rid, 3, 0, **kw)
    sa2 = cmk.fused_bounce(cms, a2, rid, 3, 0, **kw)
    sb = cmk.fused_bounce_reference(cms, b, rid, 3, 0, **kw)
    assert torch.equal(a, a2) and torch.equal(sa, sa2)
    assert torch.equal(sa, sb) and torch.equal(a[9:13], b[9:13])
    live = a[cmk.ALIVE] > 0
    assert torch.equal(a[:, live], b[:, live])
    assert torch.equal(a[:, 1013:], state[:, 1013:])
    assert float(sa[1013:].abs().sum()) == 0.0
    assert float(sa[:1013].sum()) >= 1013


def test_walking_kernels_fill_the_sm(cuda):
    """At the repo's deepest tree (diningroom's, wide depth 6: 50 stack
    entries) kernels 2 and 3 keep 32 warps an SM (8 blocks of 128 threads,
    4 of 256), kernel 4 at least 8 blocks."""
    from mcpt_torch.bvh.cluster import stack_entries

    lib = _build.load()
    cap = stack_entries(6)
    assert lib.mcpt_fused_bounce_blocks_per_sm(cap) == 8
    assert lib.mcpt_render_cluster_blocks_per_sm(cap, 8, 64) == 4
    for any_hit in (0, 1):
        assert lib.mcpt_traverse_blocks_per_sm(any_hit, cap) >= 8


def test_walking_kernels_past_65536_stack_codes(cuda):
    """boxfield(60)'s tables behind 70,000 empty clusters, so every cluster
    code the walks push lies past 2^16: kernels 2 and 3 give the bits of the
    unshifted tables."""
    cmk, cms, cam, state, rid = _hybrid_setup(cuda)
    pad = 70000
    w = cms.wnodes.clone()
    codes = w[:, 48:56]
    w[:, 48:56] = torch.where(codes >= w.shape[0], codes + pad, codes)
    big = cms._replace(
        wnodes=w, n_clusters=cms.n_clusters + pad,
        tri16=torch.cat([torch.zeros((pad * cms.leaf_size, 16), device=cuda),
                         cms.tri16]),
        live=torch.cat([torch.zeros(pad, dtype=torch.int32, device=cuda),
                        cms.live]))
    kw = dict(max_depth=4, rr=True, rr_start=1, nee=True, mis=True)
    a, b = state.clone(), state.clone()
    sa = cmk.fused_bounce(big, a, rid, 3, 0, **kw)
    sb = cmk.fused_bounce(cms, b, rid, 3, 0, **kw)
    assert torch.equal(a, b) and torch.equal(sa, sb)
    kw = dict(kw, spp=2, seed=5)
    ra, sa = cmk.render_cluster_mega(big, cam, 32, 24, **kw)
    rb, sb = cmk.render_cluster_mega(cms, cam, 32, 24, **kw)
    assert torch.equal(ra, rb) and float(sa) == float(sb) > 0.0


def _random_rays(device, n=20000, seed=8):
    import numpy as np

    r = np.random.default_rng(seed)
    o = r.uniform([-150, 0.5, -150], [150, 40, 150], (n, 3))
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = r.uniform(size=n) < 0.7
    limit = r.uniform(1.0, 300.0, n)
    t = (torch.from_numpy(o.astype("float32")).to(device),
         torch.from_numpy(d.astype("float32")).to(device),
         torch.from_numpy(active).to(device),
         torch.from_numpy(limit.astype("float32")).to(device))
    return t


def test_traverse_matches_plain_version(cuda):
    """Closest hit and any-hit of random rays, 30% inactive, with random
    limits (and the closest hit without one): every field of the plain
    version's ``Hit`` and occlusion, bit for bit, one launch each."""
    from mcpt_torch.kernels import traverse_kernel as tk

    loaded, _ = scenes.boxfield(60)
    scene, _ = build_scene(loaded, device=cuda)
    cl = scene.clusters
    o, d, active, limit = _random_rays(cuda)
    before = _build.LAUNCHES["mcpt_traverse"]
    for lim in (limit, None):
        a = tk._traverse_cuda(cl, o, d, active, lim, False, 1e-4)
        b = tk.hit_from_rows(cl, o, d, *tk.traverse_reference(
            cl, o, d, active, torch.full_like(limit, 3.0e38)
            if lim is None else lim, False, 1e-4))
        assert _same_hits(a, b), lim is None
    occ = tk._traverse_cuda(cl, o, d, active, limit, True, 1e-4)
    assert torch.equal(occ, tk.traverse_reference(cl, o, d, active, limit,
                                                  True, 1e-4))
    assert _build.LAUNCHES["mcpt_traverse"] == before + 3
    hit = tk.intersect_clusters(cl, o, d, active=active)
    assert int((hit.tri >= 0).sum()) > 1000
    assert (hit.tri[~active] == -1).all()


def test_traverse_wrapper_refusals(cuda):
    from mcpt_torch.kernels import traverse_kernel as tk

    loaded, _ = scenes.boxfield(60)
    scene, _ = build_scene(loaded, device=cuda)
    cl = scene.clusters
    o, d, active, limit = _random_rays(cuda, n=256)
    with pytest.raises(ValueError, match="float32"):
        tk._traverse_cuda(cl, o.double(), d, active, limit, False)
    with pytest.raises(ValueError, match="contiguous"):
        tk._traverse_cuda(cl, o.t().contiguous().t(), d, active, limit,
                          False)
    with pytest.raises(ValueError, match="bool"):
        tk._traverse_cuda(cl, o, d, active.int(), limit, True)
    with pytest.raises(ValueError, match="CUDA"):
        tk._traverse_cuda(cl, o, d.cpu(), active, limit, True)
    with pytest.raises(ValueError, match="CUDA"):
        tk._traverse_cuda(cl._replace(tri16=cl.tri16.cpu()), o, d, active,
                          limit, False)
    with pytest.raises(ValueError, match="tri_map"):
        tk._traverse_cuda(cl._replace(tri_map=cl.tri_map.long()), o, d,
                          active, None, False)
    with pytest.raises(ValueError, match="limit"):
        tk._traverse_cuda(cl, o, d, active, None, True)


def test_cluster_mega_wrapper_refusals(cuda):
    cmk, cms, cam, _, _ = _hybrid_setup(cuda)
    with pytest.raises(ValueError, match="float32"):
        cmk.render_cluster_mega(cms._replace(tri16=cms.tri16.double()), cam,
                                8, 8, spp=1, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        cmk.render_cluster_mega(cms._replace(matt=cms.matt.cpu()), cam, 8, 8,
                                spp=1, seed=0)
    cpu_cam = cam._replace(position=cam.position.cpu())
    with pytest.raises((ValueError, RuntimeError)):
        cmk.render_cluster_mega(cms, cpu_cam, 8, 8, spp=1, seed=0)


def test_wavefront_on_cuda_goes_through_the_kernel(cuda):
    """A clustered scene on CUDA resolves to the cluster kernel: two
    launches a bounce (closest hit and NEE shadow rays), and its draws go
    through the threefry kernel: a camera draw a sample, a shade and an
    NEE draw a bounce.  Inside ``_build.plain_versions()`` neither
    launches, and the image has the same bits."""
    from mcpt_torch import rng
    from mcpt_torch.render import integrator as integ
    from mcpt_torch.render import traverse

    loaded, camcfg = scenes.boxfield(60)
    scene, lights = build_scene(loaded, device=cuda)
    cam = make_camera(dataclasses.replace(camcfg, resolution=(32, 24)),
                      device=cuda)
    assert traverse.resolve_method(scene) == "cluster"
    opts = integ.RenderOptions(max_depth=4, nee=True, mis=True,
                               russian_roulette=True, rr_start_depth=1,
                               resort=True)
    before = _build.LAUNCHES.copy()
    a, sa = integ.render_batch(scene, lights, cam, 32, 24, rng.key(2), opts,
                               spp=2, with_stats=True)
    want = collections.Counter(mcpt_traverse=2 * 4,
                               mcpt_threefry=2 + 2 * 4)
    assert _build.LAUNCHES - before == want
    with _build.plain_versions():
        b, sb = integ.render_batch(scene, lights, cam, 32, 24, rng.key(2),
                                   opts, spp=2, with_stats=True)
    assert _build.LAUNCHES - before == want
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(sa) == float(sb)


def _boxfield_clusters(device, w=32, h=24):
    loaded, camcfg = scenes.boxfield(60)
    scene, lights = build_scene(loaded, device=device)
    cam = make_camera(dataclasses.replace(camcfg, resolution=(w, h)),
                      device=device)
    return scene, lights, cam


def _same_hits(a, b):
    """Two ``types.Hit``s with the same bits in every field."""
    return all(torch.equal(x.view(torch.int32) if x.is_floating_point()
                           else x, y.view(torch.int32)
                           if y.is_floating_point() else y)
               for x, y in zip(a, b))


@pytest.mark.parametrize("n", [1, 31, 33, 1027, 20000])
@pytest.mark.parametrize("dead", ["none", "scattered", "tail", "all"])
def test_traverse_launch_on_ragged_and_dead_pools(cuda, n, dead):
    """Kernel 4 through ``intersect_clusters`` / ``occluded_clusters``, on
    pools that end mid-warp and mid-block, with no, scattered (30%), tail
    (the resort's dead rays last) and all rays inactive: every field of the
    plain version's ``Hit`` and occlusion, bit for bit, one launch each."""
    from mcpt_torch.kernels import traverse_kernel as tk

    scene, _, _ = _boxfield_clusters(cuda)
    cl = scene.clusters
    o, d, active, limit = _random_rays(cuda, n=n, seed=n)
    if dead == "none":
        active = torch.ones_like(active)
    elif dead == "tail":
        active = torch.arange(n, device=cuda) < n * 2 // 3
    elif dead == "all":
        active = torch.zeros_like(active)
    before = _build.LAUNCHES["mcpt_traverse"]
    a = tk.intersect_clusters(cl, o, d, active=active)
    occ = tk.occluded_clusters(cl, o, d, limit, active=active)
    assert _build.LAUNCHES["mcpt_traverse"] == before + 2
    with _build.plain_versions():
        b = tk.intersect_clusters(cl, o, d, active=active)
        occ_b = tk.occluded_clusters(cl, o, d, limit, active=active)
    assert _build.LAUNCHES["mcpt_traverse"] == before + 2
    assert _same_hits(a, b)
    assert torch.equal(occ, occ_b)
    assert not bool(occ[~active].any()) and bool((a.tri[~active] == -1).all())
    if dead == "all":
        assert bool(torch.isinf(a.t).all()) and torch.equal(a.point, o)


def _cyclic_clusters(cl, device):
    """``cl`` with one wide node whose 8 always-hit children are itself: a
    walk pushes past any stack cap."""
    row = torch.zeros(64, dtype=torch.float32)
    for k in range(8):
        row[6 * k: 6 * k + 3] = -1e30
        row[6 * k + 3: 6 * k + 6] = 1e30
    row[56:64] = float(sum(k << (3 * k) for k in range(8)))
    return cl._replace(wnodes=row[None].to(device))


def test_traverse_stack_overflow_raises(cuda):
    """A cyclic table overflows kernel 4's stack: ``intersect_clusters``
    and ``occluded_clusters`` raise at once outside a deferred block;
    ``integrator.trace`` reads the flag once, after its bounce loop, and
    raises there; a healthy render after it runs clean."""
    from mcpt_torch import rng
    from mcpt_torch.kernels import traverse_kernel as tk
    from mcpt_torch.render import camera as camera_mod
    from mcpt_torch.render import integrator as integ

    scene, lights, cam = _boxfield_clusters(cuda)
    bad = _cyclic_clusters(scene.clusters, cuda)
    o, d, active, limit = _random_rays(cuda, n=256)
    with pytest.raises(RuntimeError, match="stack overflow"):
        tk.intersect_clusters(bad, o, d, active=active)
    with pytest.raises(RuntimeError, match="stack overflow"):
        tk.occluded_clusters(bad, o, d, limit, active=active)
    opts = integ.RenderOptions(max_depth=3, nee=True, mis=True, resort=True)
    pool = camera_mod.generate_rays(cam, 32, 24, key=rng.key(1))
    before = _build.LAUNCHES["mcpt_traverse"]
    with pytest.raises(RuntimeError, match="stack overflow"):
        integ.trace(scene._replace(clusters=bad), lights, pool, rng.key(2),
                    opts)
    # every bounce ran: no early read
    assert _build.LAUNCHES["mcpt_traverse"] == before + 2 * 3
    assert _build._DEFERRED is None
    out = integ.trace(scene, lights, pool, rng.key(2), opts)
    assert bool(torch.isfinite(out.radiance).all())


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("shape", [(0,), (1,), (1031,), (1031, 2),
                                   (1031, 3), (1031, 6), (100003, 6)])
def test_threefry_kernel_matches_plain_version(cuda, seed, shape):
    """``rng.uniform`` and ``rng.bits`` through the threefry kernel against
    the plain version on the card, bit for bit, on ragged counts (not a
    multiple of the 4 a thread hashes), one launch each (none for an empty
    draw)."""
    from mcpt_torch import rng

    k = rng.fold_in(rng.key(seed), 3)
    before = _build.LAUNCHES["mcpt_threefry"]
    u, b = rng.uniform(k, shape, cuda), rng.bits(k, shape, cuda)
    n = 1
    for x in shape:
        n *= x
    assert _build.LAUNCHES["mcpt_threefry"] == before + (2 if n else 0)
    assert u.dtype == torch.float32 and b.dtype == torch.int64
    assert tuple(u.shape) == shape and tuple(b.shape) == shape
    with _build.plain_versions():
        u_ref, b_ref = rng.uniform(k, shape, cuda), rng.bits(k, shape, cuda)
    assert _build.LAUNCHES["mcpt_threefry"] == before + (2 if n else 0)
    assert torch.equal(u.view(torch.int32), u_ref.view(torch.int32))
    assert torch.equal(b, b_ref)
    assert torch.equal(u.cpu().view(torch.int32),
                       rng.uniform(k, shape, "cpu").view(torch.int32))


def test_threefry_kernel_config9_largest_draw(cuda):
    """Config 9's largest draw, the shade draw of a 1920x1080 step at 4 spp
    (49,766,400 uniforms), against the plain version bit for bit."""
    from mcpt_torch import rng

    k = rng.key(1234)
    shape = (1920 * 1080 * 4, 6)
    u = rng.uniform(k, shape, cuda)
    with _build.plain_versions():
        u_ref = rng.uniform(k, shape, cuda)
    assert torch.equal(u.view(torch.int32), u_ref.view(torch.int32))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


# --------------------------------------------------------------------------
# the FP32 peak probe (csrc/fma_peak.cu) and the BVH quality harness
# --------------------------------------------------------------------------


def _ulps(a, b):
    """|a - b| in float32 ulps (both finite and of one sign)."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def test_fma_chain_matches_plain_version(cuda):
    """2 blocks, LOOPS = 2: one launch, within 2 ulp of the plain version
    (the float64 emulation of a fused multiply-add; bit-equal expected)."""
    from mcpt_torch.kernels import fma_peak as fp

    gen = torch.Generator().manual_seed(5)
    x = (torch.rand((2 * fp.SUB, fp.COLS), generator=gen) + 0.5).to(cuda)
    before = _build.LAUNCHES["mcpt_fma_chain"]
    a = fp.fma_chain(x, loops=2)
    assert _build.LAUNCHES["mcpt_fma_chain"] == before + 1
    b = fp.fma_chain_reference(x, loops=2)
    assert _ulps(a, b) <= 2


def test_measure_fp32_peak_launches_the_kernel(cuda):
    from mcpt_torch import runtime
    from mcpt_torch.kernels import fma_peak as fp

    before = _build.LAUNCHES["mcpt_fma_chain"]
    rate = runtime.measure_fp32_peak(repeats=2)
    # a warm-up and two timed calls
    assert _build.LAUNCHES["mcpt_fma_chain"] == before + 3
    assert 1e12 < rate < 1e14


def test_fma_chain_refusals(cuda):
    from mcpt_torch.kernels import fma_peak as fp

    before = _build.LAUNCHES["mcpt_fma_chain"]
    with pytest.raises(ValueError, match="contiguous"):
        fp.fma_chain(torch.ones((fp.COLS, fp.SUB), device=cuda).t())
    with pytest.raises(ValueError, match="float32"):
        fp.fma_chain(torch.ones((fp.SUB, fp.COLS), dtype=torch.float16,
                                device=cuda))
    assert _build.LAUNCHES["mcpt_fma_chain"] == before


@pytest.mark.parametrize("n_boxes", [60, 400])
def test_treelet_gpu_on_cuda_equals_cpu(cuda, n_boxes):
    from mcpt_torch.bvh import lbvh, treelet_device
    from mcpt_torch.types import BVH

    loaded, _ = scenes.boxfield(n_boxes)
    bvh0 = lbvh.build_lbvh(torch.from_numpy(loaded.verts))
    a = treelet_device.optimize_treelets_device(bvh0.to(cuda))
    b = treelet_device.optimize_treelets_device(bvh0)
    for name in BVH._fields:
        assert getattr(a, name).device.type == "cuda"
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name


def test_lcv_and_epo_on_cuda(cuda):
    """LCV on the card equals LCV on the CPU; the PyTorch EPO walk on the
    card is within 1e-6 relative of the host walk."""
    from mcpt_torch.bvh import lbvh, metrics

    loaded, camcfg = scenes.boxfield(60)
    bvh = lbvh.build_lbvh(torch.from_numpy(loaded.verts))
    on_card = metrics.lcv(bvh, make_camera(camcfg, device=cuda), 64, 48)
    on_cpu = metrics.lcv(bvh, make_camera(camcfg, device="cpu"), 64, 48)
    assert on_card == on_cpu
    host = metrics.epo(bvh, loaded.verts)
    walk = metrics.epo(bvh, loaded.verts, use_native="never", device=cuda)
    assert abs(walk - host) <= 1e-6 * max(host, 1.0)


def _profiled_on_card(fn):
    """fn() under ``torch.profiler`` over the host and the card → (its
    result, Counter of its mcpt. host spans, {span: its event}, the names of
    mcpt. events on the device timeline)."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("mcpt.")]
    echoes = [e.name for e in events if e.device_type == DeviceType.CUDA
              and e.name.startswith("mcpt.")]
    return (out, collections.Counter(e.name for e in host),
            {e.name: e for e in host}, echoes)


@pytest.mark.parametrize("engine", ["mega", "cluster_mega", "hybrid",
                                    "wavefront"])
def test_engine_spans_on_the_card(cuda, engine):
    """Each engine on the card under the profiler: the bits it gives
    unprofiled; its launch, reduce and wait spans (one wait a flag read:
    kernel 2's once a step, kernel 3's each step, kernel 4's once a bounce
    loop, each deferred read with a ``flags_deferred`` count of the
    launches it covers), none echoed on the device timeline, and device
    time under the span that launches the engine's kernel."""
    from mcpt_torch import rng
    from mcpt_torch.render import integrator as integ

    kw = dict(spp=2, seed=4, max_depth=4, nee=True, mis=True, rr=True,
              rr_start=1)
    if engine == "mega":
        mega, cam = _setup("cornell_box", 24, 16, cuda)

        def render():
            return mk.render_mega(mega, cam, 24, 16, **kw)
        want = {"mcpt.mega.launch": 1, "mcpt.mega.reduce": 1}
        launcher = "mcpt.mega.launch"
    elif engine == "wavefront":
        loaded, camcfg = scenes.boxfield(60)
        scene, lights = build_scene(loaded, device=cuda)
        cam = make_camera(dataclasses.replace(camcfg, resolution=(32, 24)),
                          device=cuda)
        opts = integ.RenderOptions(max_depth=4, nee=True, mis=True,
                                   russian_roulette=True, rr_start_depth=1,
                                   resort=True)

        def render():
            return integ.render_batch(scene, lights, cam, 32, 24,
                                      rng.key(2), opts, spp=2,
                                      with_stats=True)
        want = {"mcpt.wavefront.camera": 2, "mcpt.rng.uniform": 2 + 2 * 4,
                "mcpt.wavefront.closest_hit": 4, "mcpt.wavefront.any_hit": 4,
                "mcpt.wavefront.shade": 4, "mcpt.wavefront.nee": 4,
                "mcpt.wavefront.resort": 4, "mcpt.wavefront.resort_keys": 4,
                "mcpt.wait.k4_flag": 1, "mcpt.count.flags_deferred=8": 1}
        launcher = "mcpt.wavefront.closest_hit"
    elif engine == "cluster_mega":
        cmk, cms, cam, _, _ = _hybrid_setup(cuda)

        def render():
            return cmk.render_cluster_mega(cms, cam, 32, 24, **kw)
        want = {"mcpt.cluster_mega.launch": 1, "mcpt.wait.k3_flag": 1,
                "mcpt.cluster_mega.reduce": 1}
        launcher = "mcpt.cluster_mega.launch"
    else:
        cmk, cms, cam, _, _ = _hybrid_setup(cuda)

        def render():
            return cmk.render_hybrid(cms, cam, 32, 24, **kw)
        # the raygen kernel reads the camera on the card: no mcpt.wait.sf;
        # each bounce counts its pool's lanes (one quantum, 32 rows of 128);
        # kernel 2's flag is read once, after the reduce, for 4 launches
        want = {"mcpt.hybrid.raygen": 1,
                "mcpt.hybrid.bounce": 4, "mcpt.wait.k2_flag": 1,
                "mcpt.hybrid.sort": 3, "mcpt.hybrid.reduce": 1,
                "mcpt.count.k2_lanes=4096": 4,
                "mcpt.count.flags_deferred=4": 1}
        launcher = "mcpt.hybrid.bounce"
    a, sa = render()
    (b, sb), counts, spans, echoes = _profiled_on_card(render)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(sa) == float(sb)
    assert dict(counts) == want and echoes == []
    assert spans[launcher].device_time_total > 0.0
