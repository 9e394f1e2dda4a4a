"""repro_torch.train — training objectives (slice 2: the soft-sDTW
loss; the LM training of ``repro.train`` is slice 10)."""
