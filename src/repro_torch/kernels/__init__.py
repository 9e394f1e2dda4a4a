"""repro_torch.kernels — the hand-written CUDA kernels of the port (built
at first use from ``csrc/``), their wrappers and plain versions."""
