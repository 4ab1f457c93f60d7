"""Hand-written CUDA kernels (sources in ``repro_torch/csrc/``), each beside
its plain PyTorch version and a launch counter; built on first CUDA use."""
