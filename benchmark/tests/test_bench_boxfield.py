"""The open box field's cell on the CPU: a tiny cell of the ``boxfield``
configuration run through the harness's hybrid engine, sound and with the
bfloat16 control in its place.

    python -m pytest benchmark/tests -q
"""

import json

import pytest
import torch
from benchtools import ROOT, tiny_checkout

from benchmark import check, harness

BENCH = ROOT / "benchmark"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxfield_cell(tmp_path):
    cfg = json.loads((BENCH / "configs" / "boxfield.json").read_text())
    cfg.update(name="tiny", width=16, height=9)
    root = tiny_checkout(tmp_path, engine="hybrid", spp=2, cfg=cfg)
    (root / "benchmark" / "limits" / "tiny-hybrid.json").write_text(
        (BENCH / "limits" / "boxfield-hybrid-step4.json").read_text())
    return harness.load_cell("tiny-hybrid", root)


def test_bench_boxfield_tiny_cell_reads_correct_and_its_control_does_not(
        tmp_path):
    """The boxfield configuration at 16×9 through the harness's own window:
    the program's numbers pass the cell's limits, and the reference in
    bfloat16 in the program's place fails them."""
    from benchmark.control import readings

    cell = _boxfield_cell(tmp_path)
    assert (cell.cfg["maxdepth"], cell.cfg["scene"]) == (8, "boxfield")
    prog = harness.build(cell, torch.device("cpu"))
    win = harness.window(cell, prog, 2**32 + 11, 0.3, False,
                         torch.device("cpu"))
    pixels = harness.sample_pixels(2**32 + 11, 144, int(cell.limits["pixels"]))
    rad, count = harness.framebuffer_at(win.fb, pixels, "cpu")
    out = readings(cell, prog.scene, 2**32 + 11, win, rad, count, "cpu")
    assert check.verdict(out["program"], cell.limits), out["program"]
    assert not check.verdict(out["control"], cell.limits)
    assert out["control"]["pixel_gap_p90"] > cell.limits["pixel_gap_p90"]
    assert out["control"]["pixel_gap_mean"] > cell.limits["pixel_gap_mean"]
