"""The port's batched treelet optimiser (``treeletGPU``) against ``mcpt``'s.

``mcpt.bvh.treelet_device`` is XLA, run here in a child process without FMA
(``test_torch_megakernel.jax_child``): in this process XLA contracts the
box-area and DP-cost multiply-adds, and a changed last bit moves a DP tie.
Without FMA both round every product and sum, and the tables must be equal:
exact equality, no tolerance.  Beside that, ``mcpt``'s own checks
(``tests/test_treelet_device.py``): a real SAH gain over the LBVH, within 3%
of the CPU optimiser, a valid tree, and a tree of under 8 triangles passed
through as it is.
"""

import numpy as np
import pytest
import torch

from mcpt_torch import scenes as tscenes
from mcpt_torch.bvh import lbvh as tlbvh
from mcpt_torch.bvh import treelet as ttreelet
from mcpt_torch.bvh import treelet_device as ttd
from mcpt_torch.bvh.lbvh import one_thread
from mcpt_torch.bvh.metrics import sah
from mcpt_torch.types import BVH
from test_torch_megakernel import jax_child

_JAX_TREELET_DEVICE = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from mcpt import scenes
from mcpt.bvh import lbvh, treelet_device
a = json.loads(sys.argv[1])
out = {}
for n in a["sizes"]:
    loaded, _ = scenes.boxfield(n)
    bvh = treelet_device.optimize_treelets_device(
        lbvh.build_lbvh(jnp.asarray(loaded.verts)))
    for f in ("bbmin", "bbmax", "left", "right", "parent"):
        out[f"{n}_{f}"] = np.asarray(getattr(bvh, f))
np.savez(a["out"], **out)
"""
SIZES = (60, 400)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Loops of small CPU ops; see ``mcpt_torch.bvh.lbvh.one_thread``."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def mcpt_tables(tmp_path_factory):
    """``mcpt``'s treeletGPU tables of boxfield(60) and boxfield(400)."""
    return jax_child(tmp_path_factory.mktemp("treelet_device"),
                     _JAX_TREELET_DEVICE, sizes=list(SIZES))


def _lbvh(n_boxes):
    loaded, _ = tscenes.boxfield(n_boxes)
    verts = torch.from_numpy(loaded.verts)
    return tlbvh.build_lbvh(verts), verts


@pytest.mark.parametrize("n_boxes", SIZES)
def test_tables_equal_mcpt(mcpt_tables, n_boxes):
    bvh0, verts = _lbvh(n_boxes)
    got = ttd.optimize_treelets_device(bvh0)
    for name in BVH._fields:
        g = getattr(got, name).numpy()
        w = mcpt_tables[f"{n_boxes}_{name}"]
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the input tree is left as it was
    np.testing.assert_array_equal(bvh0.left.numpy(),
                                  tlbvh.build_lbvh(verts).left.numpy())


def test_sah_gain_and_validity():
    """``mcpt``'s bounds on boxfield(400): below 0.9× the LBVH's SAH and
    within 3% of the CPU (numpy) treelet optimiser; a valid tree."""
    bvh0, verts = _lbvh(400)
    s0 = sah(bvh0)
    s_cpu = sah(ttreelet.optimize_treelets(bvh0, native=False))
    got = ttd.optimize_treelets_device(bvh0)
    s_dev = sah(got)
    assert s_dev < 0.9 * s0, (s_dev, s0)
    assert s_dev <= 1.03 * s_cpu, (s_dev, s_cpu)
    check = tlbvh.validate_bvh(got, verts.numpy())
    assert check["ok"], check["errors"][:5]


def test_small_tree_passes_through():
    verts = torch.from_numpy(np.random.default_rng(0).normal(
        size=(5, 3, 3)).astype(np.float32))
    bvh0 = tlbvh.build_lbvh(verts)
    out = ttd.optimize_treelets_device(bvh0)
    assert out is bvh0 and out.n_tris == 5
    assert tlbvh.validate_bvh(out, verts.numpy())["ok"]


def test_verbose_prints_build_time(capsys):
    bvh0, _ = _lbvh(60)
    ttd.optimize_treelets_device(bvh0, verbose=True)
    out = capsys.readouterr().out
    assert out.startswith("treeletGPU build time: ")
    assert "batched rounds on cpu" in out
