"""``repro_torch.dp`` — the recurrence families of the port.

Counterpart of ``repro.dp``: one sweep machinery (row-scan ref, engine,
the CUDA kernel K7) serving four recurrences over the same
(distance x reduction x band) spec space:

* ``sdtw``  — subsequence DTW (free start, free end, bottom-row fold);
* ``twed``  — Time-Warp Edit Distance (global; ``nu``, ``lam``);
* ``erp``   — Edit distance with Real Penalty (global; ``gap``);
* ``local`` — Smith–Waterman local alignment, run negated in min-space
  (the cost is minus the best local similarity; ``gap_penalty``,
  ``match_reward``).

    import repro_torch.dp as dp
    res = dp.score(queries, reference, family="twed", nu=0.5, lam=1.0)

Validation baselines live in :mod:`repro_torch.dp.oracle` (float64).
"""

from __future__ import annotations

from repro_torch.core.spec import (FAMILIES, FAMILY_RECURRENCES,
                                   DPSpec, RecurrenceSpec, recurrence)
from repro_torch.dp.oracle import dp_matrix, dp_oracle


def score(queries, reference, *, family: str = "sdtw", **kwargs):
    """Score a query batch under any recurrence family: a thin front
    door over :func:`repro_torch.sdtw` (same keyword arguments, family
    parameters included), returning the same ``SDTWResult`` — ``cost``
    the family's score, ``end`` the matched reference column."""
    from repro_torch.core.api import sdtw
    return sdtw(queries, reference, family=family, **kwargs)


__all__ = ["DPSpec", "FAMILIES", "FAMILY_RECURRENCES", "RecurrenceSpec",
           "dp_matrix", "dp_oracle", "recurrence", "score"]
