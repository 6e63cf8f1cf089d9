"""The port's dev tools (``mcpt_torch.compare``, ``make_goldens``,
``validate_hybrid``, ``crosscheck_wavefront``) against ``tools/``, on the
CPU.

- ``compare`` equals ``tools.compare.compare`` to 1e-12 on seeded random
  images, with and without exposure alignment; its CLI gates on
  ``--tolerance`` and reads the EXR and HDR files the port writes;
- the tables (``GOLDENS``, ``GATES``, the cross-check's constants) equal
  ``tools/``'s;
- ``make_goldens`` refuses ``tests/goldens/`` and unknown scene names;
- each tool's inner function at 2 spp through the plain versions writes or
  checks an image of the golden's shape and prints the tool's line.
"""

import os

import numpy as np
import pytest

from mcpt_torch import compare as tcompare
from mcpt_torch import crosscheck_wavefront as tcross
from mcpt_torch import make_goldens as tgoldens
from mcpt_torch import validate_hybrid as tvalidate
from mcpt_torch.bvh.lbvh import one_thread
from mcpt_torch.io import image as im
from test_torch_megakernel import ROOT
from tools import compare as jcompare
from tools import crosscheck_wavefront as jcross
from tools import make_goldens as jgoldens
from tools import validate_hybrid as jvalidate


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Loops of small CPU ops (``mcpt_torch.bvh.lbvh.one_thread``)."""
    with one_thread():
        yield


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compare_equals_tools(align, seed):
    r = np.random.default_rng(seed)
    a = r.uniform(0.0, 4.0, (17, 23, 3))
    b = a * 1.3 + r.normal(scale=0.05, size=a.shape)
    got = tcompare.compare(a, b, align_exposure=align)
    want = jcompare.compare(a, b, align_exposure=align)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), k
    with pytest.raises(SystemExit):
        tcompare.compare(a, b[:, :-1])


def test_compare_cli_gates_on_tolerance(tmp_path, capsys):
    """Two images the port wrote (EXR and HDR): exit 0 under the tolerance,
    1 over it; ``--flip-a`` undoes a flip."""
    r = np.random.default_rng(4)
    img = r.uniform(0.1, 2.0, (12, 10, 3)).astype(np.float32)
    im.write_exr(str(tmp_path / "a.exr"), img, half=False)
    im.write_exr(str(tmp_path / "b.exr"), img[::-1] * 1.02, half=False)
    im.write_hdr(str(tmp_path / "c.hdr"), img[::-1], flip_vertical=False)
    a, b, c = (str(tmp_path / f) for f in ("a.exr", "b.exr", "c.hdr"))
    assert tcompare.main([a, b, "--flip-a", "--tolerance", "0.03"]) == 0
    assert tcompare.main([a, b, "--flip-a", "--tolerance", "0.01"]) == 1
    assert "FAIL: rel_rmse 0.0196 > 0.01" in capsys.readouterr().out
    assert tcompare.main([a, b, "--flip-a", "--align-exposure",
                          "--tolerance", "1e-6"]) == 0
    # RGBE keeps 8 bits of mantissa: within 1% of the EXR
    assert tcompare.main([c, a, "--flip-a", "--tolerance", "0.01"]) == 0
    assert tcompare.main([a, b, "--tolerance", "0.03"]) == 1
    with pytest.raises(SystemExit):
        tcompare.load_image(str(tmp_path / "x.png"))


def test_tables_equal_tools():
    assert tgoldens.GOLDENS == jgoldens.GOLDENS
    assert tvalidate.GATES == jvalidate.GATES
    assert ((tcross.NAME, tcross.W, tcross.H, tcross.SPP, tcross.DEPTH,
             tcross.TOL) == (jcross.NAME, jcross.W, jcross.H, jcross.SPP,
                             jcross.DEPTH, jcross.TOL))
    assert (tcross.SEED, tcross.SPP_PER_STEP) == (7, 64)
    assert tvalidate.BATCH == 64 and tgoldens.STEP == 256


def test_make_goldens_refuses_committed_goldens_and_unknown_names(tmp_path):
    golden = os.path.join(ROOT, "tests", "goldens")
    before = sorted(os.listdir(golden))
    for out in (golden, os.path.join(golden, "sub")):
        with pytest.raises(SystemExit, match="refusing"):
            tgoldens.main(["--out", out, "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown scenes"):
        tgoldens.main(["cbox", "--out", str(tmp_path), "--device", "cpu"])
    assert sorted(os.listdir(golden)) == before
    assert not os.listdir(tmp_path)


def test_make_golden_quad_light_small(tmp_path, capsys):
    """quad_light_plane's row at 2 spp: a 128×128 EXR next to the committed
    golden's shape, flipped as the goldens are, and the tool's line."""
    entry = tgoldens.GOLDENS[2]
    path = tgoldens.make_golden(entry, str(tmp_path), device="cpu", spp=2)
    img = im.read_exr_rgb(path)
    golden = im.read_exr_rgb(os.path.join(ROOT, "tests", "goldens",
                                          "quad_light_plane.exr"))
    assert img.shape == golden.shape == (128, 128, 3)
    assert np.isfinite(img).all() and img.mean() > 0.0
    # 2 spp against 2048: within the noise of a few samples
    stats = tcompare.compare(img.astype(np.float64),
                             golden.astype(np.float64))
    assert stats["rel_rmse"] < 0.5, stats
    line = capsys.readouterr().out
    assert line.startswith("quad_light_plane: 128x128 @ 2 spp in ")
    assert f"-> {path}" in line


def test_validate_hybrid_cbox_small(capsys):
    """cbox's gate row at 2 spp through the plain hybrid, on Morton-chunk
    clusters and the wavefront pilot's caps: the line prints, and at 2 spp
    the gate fails as it must."""
    name, w, h, _, depth, tol = tvalidate.GATES[0]
    assert not tvalidate.validate(name, w, h, 2, depth, tol, device="cpu")
    out = capsys.readouterr().out
    assert "from the wavefront pilot (integrator.measure_schedule" in out
    line = out.strip().splitlines()[-1]
    assert line.startswith("cornell_box  128x128 spp=2 depth=16 rel_rmse=")
    assert "(gate 0.025)" in line and line.endswith("FAIL | device=cpu")


def test_crosscheck_wavefront_small(capsys):
    """The cross-check at 2 spp through the CPU BVH walk: the line prints
    and the 2-spp image fails the 1024-spp gate."""
    assert not tcross.crosscheck(device="cpu", spp=2)
    line = capsys.readouterr().out.strip()
    assert line.startswith("diningroom   160x90 spp=2 depth=8 "
                           "wavefront(method=bvh) rel_rmse=")
    assert line.endswith("FAIL | device=cpu")


@pytest.mark.parametrize("tool", [tgoldens, tvalidate, tcross])
def test_tools_raise_without_a_card(tool, tmp_path):
    """``--device cuda`` (the default) never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["quad_light_plane", "--out", str(tmp_path)] if tool is tgoldens \
        else []
    with pytest.raises((RuntimeError, AssertionError)):
        tool.main(argv)
