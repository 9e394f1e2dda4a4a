"""Batch z-normalization (the paper's normalizer, §5.1).

Each series is standardized to mean 0 / std 1 with the cuDTW++ moment
formulation the paper adopts (biased ``E[x^2] - E[x]^2``, ``std =
sqrt(max(var, eps))``).  Counterpart of ``repro.core.normalize``, but
where the JAX front door computes this in plain jnp, the port's goes
through the K2 kernel (``repro_torch.kernels.normalizer``): the kernel
on a CUDA tensor, the plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import normalizer


def normalize_batch(x: torch.Tensor, *, eps: float = normalizer.EPS
                    ) -> torch.Tensor:
    """Z-normalize along the last axis. x: (..., L) -> float32 (..., L)."""
    flat = x.to(torch.float32).reshape(-1, x.shape[-1]).contiguous()
    return normalizer.normalize(flat, eps=eps).reshape(x.shape)
