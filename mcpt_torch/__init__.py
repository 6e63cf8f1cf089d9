"""mcpt_torch — the PyTorch + CUDA port of ``mcpt`` for NVIDIA Hopper (H100).

``mcpt`` (JAX/Pallas on a TPU) stays the reference; this package mirrors its
module names so each counterpart is easy to find:

- ``mcpt_torch.config``     — config.json schema (copy of ``mcpt.config``)
- ``mcpt_torch.types``      — scene / camera / framebuffer NamedTuples of tensors
- ``mcpt_torch.io``         — obj/mtl loading, HDR/PNG/EXR image IO
- ``mcpt_torch.scenes``     — procedural scenes (cornell box et al.)
- ``mcpt_torch.scene``      — scene assembly (Wald transforms, light table)
- ``mcpt_torch.render``     — camera basis, framebuffer accumulation
- ``mcpt_torch.kernels``    — hand-written CUDA kernels + their plain twins
- ``mcpt_torch.convert``    — state conversion to and from ``mcpt``
- ``mcpt_torch.render_cli`` — the progressive render CLI

Importing the package loads no kernel and touches no device: kernels are
built with ``nvcc`` and loaded on first use (``mcpt_torch.kernels._build``).
Every function that allocates takes an explicit ``device``.
"""

__version__ = "0.1.0"
