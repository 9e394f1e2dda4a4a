"""repro_torch.core — batched subsequence DTW in PyTorch: the spec, the
oracles, the engine, the front door and the session."""
