"""Kernel 5: the FP32 fused multiply-add peak probe.

Port of the Pallas kernel inside ``mcpt/runtime.py``'s ``measure_vpu_peak``
(:152; body :171-180, ``pallas_call`` at :184).  A float32 array of
``(GRID·SUB, 128)`` is cut into blocks of ``SUB`` rows; each block takes
``a = x[r0, 0]·1e-8 + 1.0000001`` and ``b = x[r0, 1]·1e-8 + 1e-9`` from its
first row ``r0``, and every element runs ``v = v·a + b`` ``UNROLL·loops``
times.  ``runtime.measure_fp32_peak`` times it for the card's FP32 rate.

Three layers: ``fma_chain_reference``, the plain version; ``_fma_chain_cuda``,
which launches ``mcpt_torch/csrc/fma_peak.cu`` (one fused multiply-add,
``__fmaf_rn``, per step); and the dispatch in ``fma_chain``
(``_build.use_kernel``): CPU tensors run the plain version, CUDA tensors
launch the kernel, anything else raises.
"""

from __future__ import annotations

import torch

from mcpt_torch.kernels import _build

# mcpt's probe (mcpt/runtime.py:169): 512 blocks of 256 rows, 256 FMAs a loop
# iteration, 32 iterations
SUB, COLS, UNROLL, LOOPS, GRID = 256, 128, 256, 32, 512


def flops(rows: int, loops: int = LOOPS) -> float:
    """Float operations of one probe over ``rows`` rows: two per FMA."""
    return 2.0 * rows * COLS * UNROLL * loops


def _coefficients(x: torch.Tensor):
    """Each block's (a, b), shaped (n_blocks, 1, 1), in float32."""
    first = x.reshape(-1, SUB, COLS)[:, :1, :2]
    return first[..., :1] * 1e-8 + 1.0000001, first[..., 1:] * 1e-8 + 1e-9


def fma_chain_reference(x: torch.Tensor, unroll: int = UNROLL,
                        loops: int = LOOPS) -> torch.Tensor:
    """The plain version: each step rounds once, as a fused multiply-add
    does.  The product of two float32 values is exact in float64, so
    ``v·a`` is taken there, ``b`` added, and the sum rounded to float32."""
    a, b = (c.double() for c in _coefficients(x))
    v = x.reshape(-1, SUB, COLS)
    for _ in range(unroll * loops):
        v = (v.double() * a + b).float()
    return v.reshape(x.shape)


def _fma_chain_cuda(x: torch.Tensor, loops: int = LOOPS) -> torch.Tensor:
    """Launch ``mcpt_torch/csrc/fma_peak.cu`` on the current stream."""
    out = torch.empty_like(x)
    _build.launch("mcpt_fma_chain", x.device, x.data_ptr(), out.data_ptr(),
                  x.shape[0] // SUB, loops)
    return out


def fma_chain(x: torch.Tensor, loops: int = LOOPS) -> torch.Tensor:
    """The probe's function on ``x`` (float32, contiguous, ``(k·SUB, 128)``),
    ``UNROLL·loops`` steps → a new tensor of its shape.  On CUDA the kernel;
    on the CPU the plain version."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != COLS \
            or x.shape[0] % SUB or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 (k·{SUB}, {COLS}) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if _build.use_kernel("fma_chain", x):
        return _fma_chain_cuda(x, loops)
    return fma_chain_reference(x, UNROLL, loops)
