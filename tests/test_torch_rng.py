"""The port's threefry (``mcpt_torch.rng``) against ``jax.random``, bit for
bit: ``key``, ``fold_in``, ``split``, ``uniform`` and a vmapped split, on
several seeds and the shapes the wavefront draws ((n,), (n, 2), (n, 3),
(n, 6)).  No tolerance: the bits must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt_torch import convert, rng
from mcpt_torch.kernels import _build

SEEDS = [0, 1, 1234, 7919, 2**31 - 1]


def _words(k) -> tuple:
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["key_fold_in_split", "uniform_n",
                                  "uniform_n2", "uniform_n3", "uniform_n6",
                                  "vmap_split"])
def test_threefry_equals_jax_random(seed, case):
    jk, tk = jax.random.key(seed), rng.key(seed)
    assert _words(jk) == tuple(tk)
    jf, tf = jax.random.fold_in(jk, 7 + seed % 5), rng.fold_in(tk,
                                                                7 + seed % 5)
    assert _words(jf) == tuple(tf)
    assert convert.key_from_data(jax.random.key_data(jf)) == tf
    if case == "key_fold_in_split":
        for n in (2, 3, 5):
            want = [_words(k) for k in jax.random.split(jf, n)]
            assert want == [tuple(k) for k in rng.split(tf, n)]
    elif case.startswith("uniform"):
        shape = {"uniform_n": (1000,), "uniform_n2": (999, 2),
                 "uniform_n3": (1000, 3), "uniform_n6": (333, 6)}[case]
        want = np.asarray(jax.random.uniform(jf, shape, jnp.float32))
        got = rng.uniform(tf, shape, "cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        keys = jax.random.split(jf, 4)
        want = np.asarray(jax.random.key_data(
            jax.vmap(lambda k: jax.random.split(k, 3))(keys)))
        # a vmapped split is the split of each key
        got = [[tuple(x) for x in rng.split(k, 3)] for k in rng.split(tf, 4)]
        assert want.tolist() == [[list(x) for x in ks] for ks in got]


@pytest.mark.parametrize("fn", [rng.uniform, rng.bits])
def test_draws_refuse_other_devices(fn):
    """The draws run on the CPU (the plain version) or CUDA (the threefry
    kernel); any other device raises, and nothing falls back."""
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn(rng.key(1), (8, 2), "meta")


def test_plain_draws_never_count_launches():
    """CPU draws run the plain version, inside the plain context or not,
    and count no kernel launch."""
    before = _build.LAUNCHES["mcpt_threefry"]
    a = rng.uniform(rng.key(3), (257, 3), "cpu")
    with _build.plain_versions():
        b = rng.uniform(rng.key(3), (257, 3), "cpu")
    assert _build.LAUNCHES["mcpt_threefry"] == before and not _build._PLAIN
    assert torch.equal(a, b)
