"""DPSpec — the declarative recurrence spec every backend of the port
consumes, with the cell helpers written in torch.

The recurrence is the paper's subsequence DTW

    D[i, j] = cost(q[i], r[j]) + min(D[i-1, j], D[i, j-1], D[i-1, j-1])

with the free start ``D[-1, j] = 0``.  Field names, defaults and the
sentinel values are those of ``repro.core.spec`` so that one spec (as a
plain dict, see ``repro_torch.convert``) drives both packages.

Hard-min and soft-min subsequence DTW are ported.  A spec outside
them (another recurrence family, a bf16 accumulator) raises
:class:`NotPortedError`, which names the ROADMAP slice that brings it.
"""

from __future__ import annotations

import dataclasses
import math
import numbers

import torch

DISTANCES = ("sqeuclidean", "abs", "cosine")
REDUCTIONS = ("hardmin", "softmin")
FAMILIES = ("sdtw", "twed", "erp", "local")

# ----------------------------------------------------------- sentinels
INF = math.inf
#   Hard-min accumulators of the engine and the row-scan ref: +inf is the
#   identity of ``min``; masked cells are overwritten before any read.
SOFT_BIG = 1e30
#   Soft-min accumulators (engine, ref, the soft CUDA sweeps): FINITE,
#   so that ``exp(-SOFT_BIG / gamma)`` underflows to exactly 0.0 and no
#   ``inf - inf = NaN`` enters the min-shifted logsumexp or its
#   gradient; 1e30 leaves ~8 orders of magnitude below the f32 max, so
#   ``cost + SOFT_BIG`` and ``SOFT_BIG / gamma`` cannot overflow.
KERNEL_BIG = 3.0e38
#   The CUDA wavefront's masked-cell / edge sentinel: finite, so that
#   ``cost + KERNEL_BIG`` never produces inf - inf arithmetic.  In a
#   hard-min sweep a valid cell always has a finite predecessor, so the
#   sentinel never wins and the kernel's values equal the engine's
#   (which uses INF) bit for bit.
PAD_VALUE = 1.0e6
#   The JAX kernel's reference padding value.  The port does not pad
#   with it: its wavefront guards ``j < n`` in the fold instead.
NO_WINDOW = -1
#   The int32 "no window found" start/end sentinel.


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that this slice of the port lacks."""


def not_ported(what: str, slice_: str) -> NotPortedError:
    return NotPortedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, {slice_}); "
        f"the JAX package repro serves it")


@dataclasses.dataclass(frozen=True)
class DPSpec:
    """Frozen, hashable recurrence spec (fields as in ``repro``)."""

    distance: str = "sqeuclidean"
    reduction: str = "hardmin"
    gamma: float = 1.0           # softmin temperature
    band: int | None = None      # Sakoe–Chiba radius, None = unbanded
    accum_dtype: str = "float32"
    family: str = "sdtw"
    nu: float = 1.0              # twed stiffness
    lam: float = 1.0             # twed deletion penalty
    gap: float = 0.0             # erp gap value
    gap_penalty: float = 1.0     # local alignment gap penalty
    match_reward: float = 1.0    # local alignment match reward

    def __post_init__(self):
        if self.distance not in DISTANCES:
            raise ValueError(f"unknown distance {self.distance!r}; "
                             f"choose from {DISTANCES}")
        if self.reduction not in REDUCTIONS:
            raise ValueError(f"unknown reduction {self.reduction!r}; "
                             f"choose from {REDUCTIONS}")
        if self.family not in FAMILIES:
            raise ValueError(f"unknown recurrence family {self.family!r}; "
                             f"choose from {FAMILIES}")
        if self.reduction == "softmin" and not self.gamma > 0:
            raise ValueError(f"softmin needs gamma > 0, got {self.gamma}")
        if self.band is not None and (
                isinstance(self.band, bool)
                or not isinstance(self.band, numbers.Integral)
                or self.band < 0):
            raise ValueError(f"band must be an int >= 0 or None, "
                             f"got {self.band!r}")
        if self.family != "sdtw":
            raise not_ported(f"recurrence family {self.family!r}",
                             "slice 4")
        if self.accum_dtype != "float32":
            raise not_ported(f"accum_dtype={self.accum_dtype!r}",
                             "queue 2, bf16-K1")

    @property
    def soft(self) -> bool:
        return self.reduction == "softmin"

    @property
    def big(self) -> float:
        """The masked/initial-cell sentinel of this reduction: ``INF``
        for hard-min, the finite ``SOFT_BIG`` for soft-min."""
        return SOFT_BIG if self.soft else INF

    def describe(self) -> str:
        parts = [self.distance, self.reduction]
        if self.soft:
            parts.append(f"gamma={self.gamma:g}")
        if self.band is not None:
            parts.append(f"band={self.band}")
        return "/".join(parts)

    # ---------------------------------------------------- cell helpers
    def cell_cost(self, q, r):
        """Elementwise local cost; broadcasts like ``q - r``.  The
        squared distance is ``d * d`` so that it rounds exactly as the
        CUDA kernel's ``__fmul_rn(d, d)``."""
        if self.distance == "sqeuclidean":
            d = q - r
            return d * d
        if self.distance == "abs":
            return torch.abs(q - r)
        return 1.0 - (q * r) / (torch.abs(q) * torch.abs(r) + 1e-8)

    def reduce3(self, left, up, upleft):
        """The 3-way predecessor reduction.  Hard-min keeps the operand
        order ``min(min(left, up), upleft)``.  Soft-min is
        ``-gamma * logsumexp(-x / gamma)`` in min-shifted form, as in
        ``repro.core.spec.DPSpec.reduce3``: every exponent is <= 0 by
        construction, and the shift contributes no gradient."""
        mn = torch.minimum(torch.minimum(left, up), upleft)
        if not self.soft:
            return mn
        s = (torch.exp(-(left - mn) / self.gamma)
             + torch.exp(-(up - mn) / self.gamma)
             + torch.exp(-(upleft - mn) / self.gamma))
        return mn - self.gamma * torch.log(s)

    def cell_update(self, cost, left, up, upleft, *, free_start=None):
        """One DP cell: ``cost + reduce3(...)``; where ``free_start`` is
        True (query row 0) the reduced predecessor is exactly 0."""
        prev = self.reduce3(left, up, upleft)
        if free_start is not None:
            prev = torch.where(free_start, torch.zeros_like(prev), prev)
        return cost + prev

    def band_valid(self, i, j):
        """Sakoe–Chiba mask ``|i - j| <= band`` (None when unbanded)."""
        if self.band is None:
            return None
        return torch.abs(torch.as_tensor(i) - torch.as_tensor(j)) \
            <= self.band

    def start3(self, left, up, upleft, s_left, s_up, s_upleft):
        """Start pointer of the predecessor the hard-min picks: on a tie
        ``left`` beats ``up`` and the inner min beats ``upleft`` (strict
        ``<`` flips the winner), as in ``repro.core.spec.DPSpec.start3``."""
        s = torch.where(up < left, s_up, s_left)
        return torch.where(upleft < torch.minimum(left, up), s_upleft, s)


DEFAULT_SPEC = DPSpec()


def resolve_spec(spec: DPSpec | None = None, *, distance: str | None = None,
                 reduction: str | None = None, gamma: float | None = None,
                 band: int | None = None,
                 family: str | None = None) -> DPSpec:
    """Merge per-call overrides over an optional base spec; ``gamma``
    alone implies ``reduction="softmin"``, as in ``repro``."""
    base = spec if spec is not None else DEFAULT_SPEC
    if gamma is not None and reduction is None:
        reduction = "softmin"
    updates = {k: v for k, v in [("distance", distance),
                                 ("reduction", reduction),
                                 ("gamma", gamma), ("band", band),
                                 ("family", family)]
               if v is not None}
    return dataclasses.replace(base, **updates) if updates else base


def validate_batch_inputs(queries, reference) -> None:
    """The public batch contract: queries (B, M), reference (N,),
    non-empty everywhere."""
    if queries.ndim != 2:
        raise ValueError(
            f"queries must be 2-D (batch, length), got shape "
            f"{tuple(queries.shape)}")
    if reference.ndim != 1:
        raise ValueError(
            f"reference must be 1-D (length,), got shape "
            f"{tuple(reference.shape)}")
    if queries.shape[0] == 0:
        raise ValueError("empty query batch (queries.shape[0] == 0)")
    if queries.shape[1] == 0:
        raise ValueError("zero-length queries (queries.shape[1] == 0)")
    if reference.shape[0] == 0:
        raise ValueError("empty reference (reference.shape[0] == 0)")
