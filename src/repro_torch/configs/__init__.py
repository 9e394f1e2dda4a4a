"""repro_torch.configs — the workloads the port is sized against."""
