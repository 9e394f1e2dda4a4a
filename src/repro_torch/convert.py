"""Carry the JAX package's state across to the port.

sDTW has no learned weights.  What makes both packages compute the same
thing is the recurrence spec and a session's (normalized) reference,
handed over as plain Python values and numpy arrays — this module
imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.session import Aligner
from repro_torch.core.spec import DPSpec

_FIELDS = frozenset(f.name for f in dataclasses.fields(DPSpec))


def spec_from_dict(d: dict) -> DPSpec:
    """The port's :class:`DPSpec` from ``dataclasses.asdict`` of a
    ``repro.core.spec.DPSpec``, soft-min specs (``gamma``) and the
    recurrence families (``family``, ``nu``, ``lam``, ``gap``,
    ``gap_penalty``, ``match_reward``) included.  Unknown fields raise
    ``ValueError``; a bf16 accumulator (``accum_dtype``), which the port
    does not serve yet, raises ``NotPortedError``."""
    unknown = set(d) - _FIELDS
    if unknown:
        raise ValueError(f"unknown DPSpec field(s) {sorted(unknown)}; "
                         f"known: {sorted(_FIELDS)}")
    return DPSpec(**d)


def aligner_from_numpy(reference_normalized: np.ndarray, spec_dict: dict,
                       *, device=None, segment_width: int = 8,
                       backend: str | None = None) -> Aligner:
    """A port :class:`Aligner` over a JAX session's normalized reference
    (``np.asarray(repro_aligner.reference)``), with ``normalize=False``
    so the reference is used as it is."""
    ref = np.asarray(reference_normalized, dtype=np.float32)
    return Aligner(ref, spec=spec_from_dict(spec_dict), backend=backend,
                   normalize=False, device=device,
                   segment_width=segment_width)
