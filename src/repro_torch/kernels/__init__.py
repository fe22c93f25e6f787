"""Hand-written CUDA kernels of the port (sources under ``csrc/``), each
beside its plain PyTorch version; built by ``nvcc`` at first use
(:mod:`._build`)."""
