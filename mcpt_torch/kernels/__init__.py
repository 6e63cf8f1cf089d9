"""Hand-written Hopper kernels (sources in ``mcpt_torch/csrc/``), each beside
its plain PyTorch version and a dispatcher that takes the plain version only
for CPU tensors."""
