"""Differentiable soft subsequence DTW: the engine with a soft-min
reduction.

    softmin_gamma(a) = -gamma * log(sum_i exp(-a_i / gamma))

(Cuturi & Blondel 2017) replaces ``min`` in every cell and in the
bottom-row readout, so the map queries -> cost is differentiable under
``torch.autograd``; as gamma -> 0 it recovers hard sDTW.  Counterpart of
``repro.core.softdtw``.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import sdtw_engine
from repro_torch.core.spec import DPSpec


def sdtw_soft(queries: torch.Tensor, reference: torch.Tensor,
              gamma: float = 1.0, *, band: int | None = None
              ) -> torch.Tensor:
    """Soft-sDTW cost per query: queries (B, M), reference (N,) ->
    (B,) float32, differentiable with respect to both."""
    spec = DPSpec(reduction="softmin", gamma=float(gamma), band=band)
    cost, _ = sdtw_engine(queries, reference, spec=spec)
    return cost
