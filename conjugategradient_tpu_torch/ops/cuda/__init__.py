"""Hand-written CUDA kernels (sources in ``csrc/``), built on first use."""
