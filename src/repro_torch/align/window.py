"""Matched-window helpers — WHERE a query aligns, not just how well.

Counterpart of ``repro.align.window``.  Window requests go through the
front door::

    res = repro_torch.sdtw(queries, reference,
                           outputs=("cost", "start", "end"))

which threads a start-column pointer through the sweep (K3 on the card,
K4 with the start lane under a band), so the (cost, start, end) triple
falls out of the SAME O(M)-memory sweep — no second pass, no
materialized matrix.  Soft-min specs have no argmin path — ask
``outputs=("soft_alignment",)`` (:mod:`repro_torch.align.soft`) for the
expected alignment instead.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def window_arrays(starts, ends):
    """Convenience: (starts, ends) -> list of ``slice`` objects over the
    reference (inclusive ends, like the kernel's clamped indices)."""
    return [slice(int(s), int(e) + 1)
            for s, e in zip(_host(starts), _host(ends))]
