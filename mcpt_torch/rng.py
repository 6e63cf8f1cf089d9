"""Threefry-2x32 keys and uniform draws, bit-equal to ``jax.random``.

The port's counterpart of the ``jax.random`` calls the wavefront engine
makes (``key``, ``fold_in``, ``split``, ``uniform``), with the partitionable
counters (``jax_threefry_partitionable``, on by default since JAX 0.5):

- a key is a pair of uint32 words ``(k1, k2)``; ``key(seed)`` is
  ``(seed >> 32, seed & 0xFFFFFFFF)``, so ``(0, seed)`` for a 32-bit seed;
- ``fold_in(k, d)`` hashes the counter pair ``(0, d)``;
- ``split(k, n)`` and the bits behind ``uniform(k, shape)`` hash the
  counters of a flat 64-bit iota over the shape, as (hi, lo) words;
- ``uniform`` takes ``bits1 ^ bits2``, keeps its top 23 bits as the
  mantissa of a float in [1, 2) and subtracts 1.

Three layers for ``bits`` and ``uniform``: ``threefry2x32``, the plain
version, with uint32 arithmetic held in int64 tensors masked to 32 bits
(torch's ``>>`` on int32 is arithmetic, so no signed 32-bit value is ever
shifted); ``_threefry_cuda``, which launches ``mcpt_torch/csrc/threefry.cu``
(one pass, uint32 words, only the output written); and the dispatch in
``_draw`` (``_build.use_kernel``): CPU tensors run the plain version, CUDA
tensors launch the kernel, any other device raises.  Nothing falls back.
A key lives on the host as two Python ints (``Key``), and ``key``,
``fold_in`` and ``split`` stay scalar hashes on the host; the draws land by
default on the card, as ``jax.random``'s land on the accelerator.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mcpt_torch.kernels import _build
from mcpt_torch.trace import spanned

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


class Key(NamedTuple):
    """One threefry key: two uint32 words (``jax.random.key_data``)."""

    k1: int
    k2: int


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash of counter pairs (x1, x2) under key (k1, k2):
    20 rounds with five key injections (``jax._src.prng
    ._threefry2x32_lowering``).  Keys are ints or int64 tensors that
    broadcast against the counters; every value lies in [0, 2³²)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def key(seed: int) -> Key:
    """``jax.random.key(seed)``'s words."""
    seed = int(seed)
    hi = (seed >> 32) & _M32 if not -(1 << 31) <= seed < (1 << 31) else 0
    return Key(hi, seed & _M32)


def _scalar_hash(k: Key, x1: int, x2: int) -> Key:
    a, b = threefry2x32(torch.tensor(k.k1), torch.tensor(k.k2),
                        torch.tensor(x1), torch.tensor(x2))
    return Key(int(a), int(b))


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``: the hash of the counter (0, data)."""
    return _scalar_hash(k, 0, int(data) & _M32)


def _iota(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def split(k: Key, n: int = 2) -> list[Key]:
    """``jax.random.split(k, n)`` → a list of n ``Key``s.  A vmapped split
    (``vmap(split)(keys)``) is this split of each key."""
    hi, lo = _iota(n, "cpu")
    a, b = threefry2x32(k.k1, k.k2, hi, lo)
    return [Key(int(x), int(y)) for x, y in zip(a.tolist(), b.tolist())]


def _threefry_cuda(k: Key, shape, device, uniform: bool) -> torch.Tensor:
    """Launch ``mcpt_torch/csrc/threefry.cu`` on the current stream of
    ``device``: float32 uniforms or int64 bits of ``shape``, the plain
    version's bits.  Raises on a refused launch."""
    out = torch.empty(tuple(shape),
                      dtype=torch.float32 if uniform else torch.int64,
                      device=device)
    n = out.numel()
    if n == 0:
        return out
    _build.launch("mcpt_threefry", out.device, k.k1 & _M32, k.k2 & _M32, n,
                  int(uniform), out.data_ptr())
    return out


def _draw(name: str, k: Key, shape, device, uniform: bool) -> torch.Tensor:
    dev = torch.device(device)
    if _build.use_kernel(name, dev):
        return _threefry_cuda(k, shape, dev, uniform)
    hi, lo = _iota(math.prod(shape), dev)
    a, b = threefry2x32(k.k1, k.k2, hi, lo)
    b = (a ^ b).reshape(tuple(shape))
    if not uniform:
        return b
    mant = (b >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def bits(k: Key, shape, device="cuda") -> torch.Tensor:
    """32 random bits per element (``jax.random.bits(k, shape)``), held in
    int64."""
    return _draw("bits", k, shape, device, uniform=False)


@spanned("mcpt.rng.uniform")
def uniform(k: Key, shape, device="cuda") -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)`` in [0, 1)."""
    return _draw("uniform", k, shape, device, uniform=True)
