"""repro_torch.align — alignment outputs above the sweep (slice 2: the
soft alignment of soft-min specs)."""
