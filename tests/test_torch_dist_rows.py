"""The sharded hybrid's row order (``mcpt_torch.dist._shard_rows``) against
the numpy construction it replaced, with no process group.

In an image no wider than one 64×64 tile the tile permutation is the
identity, so only the wider sizes make the sort do work.  Each pixel
shard renders its slice of the tile permutation and leaves its
rows in ascending pixel order; the gathered (P·local_n, 3) rows go back to
pixel order through ``out[inv]``.  The oracle below builds ``inv`` as the
host did before: the permutation padded with its edge element to P·local_n,
each slice sorted, its true rows scattered to their pixels.
"""

import types

import numpy as np
import pytest
import torch

from mcpt_torch import dist
from mcpt_torch.kernels import cluster_megakernel as cmk

CPU = torch.device("cpu")


def _numpy_rows(width, height, pixels):
    n = width * height
    local_n = dist._pad_to(n, pixels) // pixels
    perm = cmk.tile_pixels(width, height, CPU)[0].numpy()
    perm_pad = np.pad(perm, (0, pixels * local_n - n), mode="edge")
    order = np.full(perm_pad.shape[0], -1, np.int64)
    for i in range(pixels):
        part = perm_pad[i * local_n:min((i + 1) * local_n, n)]
        order[i * local_n:i * local_n + part.shape[0]] = np.sort(part)
    inv = np.empty(n, np.int64)
    real = np.nonzero(order >= 0)[0]
    inv[order[real]] = real
    return inv


@pytest.mark.parametrize("width,height,pixels", [
    (20, 20, 1), (20, 20, 3),    # the identity; a padded last slice
    (20, 20, 8),                 # slices start mid 8×4 tile
    (7, 5, 8),                   # the last slice is empty
    (70, 40, 3),                 # tiles reorder the pixels; a short slice
    (1920, 1080, 1), (1920, 1080, 4),
])
def test_shard_rows_equal_the_numpy_construction(width, height, pixels):
    inv = dist._shard_rows(width, height, pixels, CPU)
    assert inv.dtype == torch.int64 and inv.device == CPU
    np.testing.assert_array_equal(inv.numpy(),
                                  _numpy_rows(width, height, pixels))


def test_shard_rows_built_once():
    """The same arguments return the same tensor: one miss, then hits."""
    before = dist._shard_rows.cache_info()
    a = dist._shard_rows(12, 9, 2, CPU)
    b = dist._shard_rows(12, 9, 2, CPU)
    after = dist._shard_rows.cache_info()
    assert a is b
    assert after.misses - before.misses == 1
    assert after.hits - before.hits == 1


@pytest.mark.parametrize("pi,count", [(0, 16), (2, 16), (3, 15)])
def test_tile_slice_stays_a_tensor(pi, count):
    """The shard's slice is a view of the device's tile permutation; no host
    copy of the permutation comes back beside it."""
    mesh = types.SimpleNamespace(shape={"samples": 2, "pixels": 4}, si=1,
                                 pi=pi, _check=lambda: None)
    got = dist._tile_slice(mesh, 7, 9, 8, CPU)
    assert not any(isinstance(x, np.ndarray) for x in got)
    spp_local, local_n, mine = got
    perm = cmk.tile_pixels(7, 9, CPU)[0]
    assert (spp_local, local_n) == (4, 16)
    assert isinstance(mine, torch.Tensor) and mine.numel() == count
    np.testing.assert_array_equal(mine.numpy(),
                                  perm[pi * 16:pi * 16 + count].numpy())
