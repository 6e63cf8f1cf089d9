"""Kernel 5's plain version (the FP32 peak probe) against ``mcpt``'s kernel
body, and the probe's refusal to time anything but the card.

``mcpt``'s body (``mcpt/runtime.py:171-180``) is evaluated with jnp on the
CPU on 2 blocks with ``LOOPS = 2`` (512 steps): XLA may contract its
``v * a + b`` into a fused multiply-add or round the product and the sum
apart, while the plain version rounds each step once, as the kernel's
``__fmaf_rn`` does.  Rounding the product apart adds at most half an ulp a
step, so the two stay within 1e-5 relative over 512 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt_torch import runtime
from mcpt_torch.bvh.lbvh import one_thread
from mcpt_torch.kernels import _build
from mcpt_torch.kernels import fma_peak as fp


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain version is a loop of small CPU ops; see
    ``mcpt_torch.bvh.lbvh.one_thread``."""
    with one_thread():
        yield


def _jax_body(x, unroll, loops):
    """``mcpt/runtime.py:171-180`` on every block of ``x``."""
    xb = jnp.asarray(x).reshape(-1, fp.SUB, fp.COLS)
    a = xb[:, :1, :1] * 1e-8 + 1.0000001
    b = xb[:, :1, 1:2] * 1e-8 + 1e-9

    def body(_, v):
        for _ in range(unroll):
            v = v * a + b
        return v

    return np.asarray(jax.jit(lambda v: jax.lax.fori_loop(0, loops, body, v))(
        xb)).reshape(x.shape)


def _input(n_blocks, seed=0):
    r = np.random.default_rng(seed)
    return r.uniform(0.5, 1.5, (n_blocks * fp.SUB, fp.COLS)).astype(
        np.float32)


def test_plain_version_matches_mcpt_kernel_body():
    x = _input(2)
    want = _jax_body(x, fp.UNROLL, 2)
    got = fp.fma_chain_reference(torch.from_numpy(x), fp.UNROLL, 2).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # each block takes its own a and b: the two blocks' chains differ
    assert not np.array_equal(got[0], got[fp.SUB])


def test_plain_version_matches_an_independent_single_rounding_chain():
    """Bit-equal to a numpy chain built from ``mcpt``'s formulas alone: a
    and b in float32 from each block's first row, then 512 steps of the
    float64 product plus b, rounded once to float32.  Dropping b changes
    the chain, so equality checks b as well as a."""
    x = _input(2, seed=7)
    first = x.reshape(-1, fp.SUB, fp.COLS)[:, :1, :2]
    a = first[..., :1] * np.float32(1e-8) + np.float32(1.0000001)
    b = first[..., 1:] * np.float32(1e-8) + np.float32(1e-9)
    assert a.dtype == b.dtype == np.float32

    def chain(b64):
        v = x.reshape(-1, fp.SUB, fp.COLS)
        for _ in range(2 * fp.UNROLL):
            v = (v.astype(np.float64) * a.astype(np.float64)
                 + b64).astype(np.float32)
        return v.reshape(x.shape)

    want = chain(b.astype(np.float64))
    got = fp.fma_chain_reference(torch.from_numpy(x), fp.UNROLL, 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(chain(0.0), want)


def test_plain_version_rounds_each_step_once():
    """A step is round(v·a + b) with v·a exact: the float64 product of two
    float32 values needs at most 48 bits."""
    x = torch.from_numpy(_input(1, seed=3))
    a, b = fp._coefficients(x)
    v = x.reshape(-1, fp.SUB, fp.COLS)
    step = fp.fma_chain_reference(x, unroll=1, loops=1).reshape(v.shape)
    exact = v.double() * a.double() + b.double()
    torch.testing.assert_close(step, exact.float(), rtol=0, atol=0)
    # one rounding, not two: the product rounded to float32 first differs
    assert not torch.equal(step, (v * a) + b)


def test_cpu_tensors_take_the_plain_version():
    x = torch.from_numpy(_input(2, seed=1))
    before = _build.LAUNCHES["mcpt_fma_chain"]
    got = fp.fma_chain(x, loops=1)
    assert _build.LAUNCHES["mcpt_fma_chain"] == before
    torch.testing.assert_close(got, fp.fma_chain_reference(x, loops=1),
                               rtol=0, atol=0)
    assert fp.flops(x.shape[0], loops=1) == 2.0 * 512 * 128 * 256


def test_wrapper_refusals():
    with pytest.raises(ValueError, match="float32"):
        fp.fma_chain(torch.zeros((fp.SUB, fp.COLS), dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\(k"):
        fp.fma_chain(torch.zeros((fp.SUB + 1, fp.COLS)))
    with pytest.raises(ValueError, match="contiguous"):
        fp.fma_chain(torch.zeros((fp.COLS, fp.SUB)).t())


def test_measure_fp32_peak_refuses_the_cpu():
    """The probe times the card's kernel; it never times the plain version
    (mcpt's probe reports ~0.5 TFLOP a call: the probe's size is mcpt's)."""
    assert fp.flops(fp.GRID * fp.SUB) == 2.0 * 131072 * 128 * 8192
    with pytest.raises(ValueError, match="CUDA"):
        runtime.measure_fp32_peak(device="cpu")
