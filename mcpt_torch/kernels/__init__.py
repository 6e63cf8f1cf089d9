"""Hand-written Hopper kernels (sources in ``mcpt_torch/csrc/``), each beside
its plain PyTorch version and a dispatcher that takes the plain version only
for CPU tensors.  Every dispatcher, launch and launch count goes through one
seam, ``_build``: ``use_kernel`` (the device rule), ``plain_versions`` (the
plain versions on CUDA tensors), ``launch`` and ``LAUNCHES`` (by C symbol)."""
