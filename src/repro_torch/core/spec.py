"""DPSpec — the declarative recurrence spec every backend of the port
consumes, with the cell helpers written in torch.

The recurrence is the paper's subsequence DTW

    D[i, j] = cost(q[i], r[j]) + min(D[i-1, j], D[i, j-1], D[i-1, j-1])

with the free start ``D[-1, j] = 0``.  Field names, defaults and the
sentinel values are those of ``repro.core.spec`` so that one spec (as a
plain dict, see ``repro_torch.convert``) drives both packages.

Hard-min and soft-min subsequence DTW are ported, and so are the
recurrence families (twed / erp / local, ``family_cell``) that
``repro.dp`` runs through the same sweeps.  A bf16 accumulator
(``accum_dtype``) raises :class:`NotPortedError`, which names the
ROADMAP item that brings it.
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


# ---------------------------------------------------------- recurrences
@dataclasses.dataclass(frozen=True)
class RecurrenceSpec:
    """The declarative shape of one recurrence family, as in
    ``repro.core.spec.RecurrenceSpec``: the executors branch on these
    static flags (and ``fold``), never on family names.

    ``objective`` ``"max"`` families run negated in min-space (the cost
    is minus the similarity); ``free_start``/``free_end`` are the
    subsequence boundaries; ``local_floor`` is the Smith–Waterman
    restart ``min(value, 0)`` with a fold over every valid cell;
    ``uses_transitions`` adds per-predecessor costs
    (:meth:`DPSpec.transition3`); ``needs_shifted`` reads the previous
    sample of each series (twed); ``needs_prefix`` reads gap-cost
    prefix sums on the boundaries (erp)."""

    name: str
    objective: str = "min"
    free_start: bool = False
    free_end: bool = False
    local_floor: bool = False
    uses_transitions: bool = False
    needs_shifted: bool = False
    needs_prefix: bool = False

    @property
    def fold(self) -> str:
        """``row`` (fold the bottom row), ``cells`` (every valid cell)
        or ``corner`` (the single cell (m-1, n-1))."""
        if self.local_floor:
            return "cells"
        return "row" if self.free_end else "corner"


FAMILY_RECURRENCES = {
    "sdtw": RecurrenceSpec(name="sdtw", free_start=True, free_end=True),
    "twed": RecurrenceSpec(name="twed", uses_transitions=True,
                           needs_shifted=True),
    "erp": RecurrenceSpec(name="erp", uses_transitions=True,
                          needs_prefix=True),
    "local": RecurrenceSpec(name="local", objective="max",
                            free_start=True, free_end=True,
                            local_floor=True, uses_transitions=True),
}


def recurrence(family: str) -> RecurrenceSpec:
    """The frozen :class:`RecurrenceSpec` of a family name."""
    try:
        return FAMILY_RECURRENCES[family]
    except KeyError:
        raise ValueError(f"unknown recurrence family {family!r}; "
                         f"choose from {FAMILIES}") from None


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
    family: str = "sdtw"         # one of FAMILIES
    nu: float = 1.0              # twed stiffness (>= 0)
    lam: float = 1.0             # twed deletion penalty (>= 0)
    gap: float = 0.0             # erp gap value g
    gap_penalty: float = 1.0     # local alignment gap penalty (> 0)
    match_reward: float = 1.0    # local alignment match reward (> 0)

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
        if self.family == "twed" and (self.nu < 0 or self.lam < 0):
            raise ValueError(f"twed needs nu >= 0 and lam >= 0, got "
                             f"nu={self.nu}, lam={self.lam}")
        if self.family == "local":
            if not self.gap_penalty > 0:
                raise ValueError(f"local alignment needs gap_penalty > 0, "
                                 f"got {self.gap_penalty}")
            if not self.match_reward > 0:
                raise ValueError(f"local alignment needs match_reward > 0, "
                                 f"got {self.match_reward}")
        if self.accum_dtype != "float32":
            raise not_ported(
                f"accum_dtype={self.accum_dtype!r} (the engine's and "
                f"ref's accumulator)", "item 'accum_dtype'")

    @property
    def soft(self) -> bool:
        return self.reduction == "softmin"

    @property
    def big(self) -> float:
        """The masked/initial-cell sentinel of this reduction: ``INF``
        for hard-min, the finite ``SOFT_BIG`` for soft-min."""
        return SOFT_BIG if self.soft else INF

    @property
    def recurrence(self) -> RecurrenceSpec:
        """The frozen :class:`RecurrenceSpec` of this spec's family."""
        return FAMILY_RECURRENCES[self.family]

    def family_describe(self) -> str:
        """The family name with its live parameters (sdtw has none)."""
        if self.family == "twed":
            return f"twed(nu={self.nu:g},lam={self.lam:g})"
        if self.family == "erp":
            return f"erp(gap={self.gap:g})"
        if self.family == "local":
            return (f"local(gap={self.gap_penalty:g},"
                    f"match={self.match_reward:g})")
        return "sdtw"

    def describe(self) -> str:
        # the default family stays silent, as in repro
        parts = [self.distance, self.reduction]
        if self.family != "sdtw":
            parts.insert(0, self.family_describe())
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
        if not isinstance(r, torch.Tensor):   # erp's scalar gap value
            r = torch.tensor(r, dtype=q.dtype, device=q.device)
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

    def reduce2(self, a, b):
        """The two-way companion of :meth:`reduce3` (same hard/soft
        split, same min-shifted form): the local family's restart floor
        ``min(value, 0)`` runs through it."""
        mn = torch.minimum(a, b)
        if not self.soft:
            return mn
        s = (torch.exp(-(a - mn) / self.gamma)
             + torch.exp(-(b - mn) / self.gamma))
        return mn - self.gamma * torch.log(s)

    def transition3(self, qv, rv, *, q_prev=None, r_prev=None, i=None,
                    j=None):
        """Per-predecessor transition costs ``(t_left, t_up, t_diag)``
        of the non-sdtw families, in ``repro``'s operand order:

        * twed: ``d(r_j, r_{j-1}) + (nu + lam)``, ``d(q_i, q_{i-1}) +
          (nu + lam)``, ``d(q_i, r_j) + d(q_{i-1}, r_{j-1}) +
          (2 nu) |i - j|`` (``q[-1] = r[-1] = 0``);
        * erp: ``d(r_j, g)``, ``d(q_i, g)``, ``d(q_i, r_j)``;
        * local: ``gap_penalty`` twice, ``d(q_i, r_j) - match_reward``.

        The Python scalars (``nu + lam``, ``2 nu``, ...) are formed in
        double and rounded once to float32 by the tensor op, as the
        CUDA kernel's host-side constants are."""
        if self.family == "twed":
            nl = self.nu + self.lam
            t_left = self.cell_cost(rv, r_prev) + nl
            t_up = self.cell_cost(qv, q_prev) + nl
            t_diag = (self.cell_cost(qv, rv)
                      + self.cell_cost(q_prev, r_prev)
                      + (2.0 * self.nu) * torch.abs(i - j))
            return t_left, t_up, t_diag
        if self.family == "erp":
            return (self.cell_cost(rv, self.gap),
                    self.cell_cost(qv, self.gap),
                    self.cell_cost(qv, rv))
        if self.family == "local":
            gp = self.gap_penalty
            return gp, gp, self.cell_cost(qv, rv) - self.match_reward
        raise ValueError(f"family {self.family!r} has no transition "
                         f"costs (sdtw uses cell_update)")

    def family_cell(self, qv, rv, left, up, upleft, *, i, j, is_row0,
                    is_col0, q_prev=None, r_prev=None, top_boundary=None,
                    left_boundary=None, big=None):
        """One non-sdtw DP cell: the single definition the row-scan
        ref, the engine (K7's plain version) and, term for term, the
        CUDA kernel K7 execute, so their float32 grids agree bit for
        bit (``repro.core.spec.DPSpec.family_cell``).

        ``left``/``up``/``upleft`` are raw neighbour reads; the
        boundaries are injected here from ``is_row0``/``is_col0``
        (bool tensors): twed's virtual row and column -1 are ``big``
        except ``D[-1, -1] = 0``; erp's are the gap-cost prefixes
        ``top_boundary[j]`` / ``left_boundary[i]``, with the diagonal
        boundary peeled as ``B[j] - d(r_j, g)``; local's are 0, and the
        restart floor ``reduce2(value, 0)`` caps the cell.  Band masking
        stays with the caller."""
        if big is None:
            big = self.big
        t_left, t_up, t_diag = self.transition3(
            qv, rv, q_prev=q_prev, r_prev=r_prev, i=i, j=j)
        if self.family == "twed":
            up_b = torch.where(is_row0, big, up)
            left_b = torch.where(is_col0, big, left)
            upleft_b = torch.where(
                is_row0 | is_col0,
                torch.where(is_row0 & is_col0, 0.0, big), upleft)
        elif self.family == "erp":
            up_b = torch.where(is_row0, top_boundary, up)
            left_b = torch.where(is_col0, left_boundary, left)
            upleft_b = torch.where(
                is_row0, top_boundary - self.cell_cost(rv, self.gap),
                torch.where(is_col0,
                            left_boundary - self.cell_cost(qv, self.gap),
                            upleft))
        elif self.family == "local":
            up_b = torch.where(is_row0, 0.0, up)
            left_b = torch.where(is_col0, 0.0, left)
            upleft_b = torch.where(is_row0 | is_col0, 0.0, upleft)
        else:
            raise ValueError("family_cell serves non-sdtw families only; "
                             "sdtw cells go through cell_update")
        val = self.reduce3(left_b + t_left, up_b + t_up, upleft_b + t_diag)
        if self.family == "local":
            val = self.reduce2(val, torch.zeros_like(val))
        return val

    def gap_prefix(self, x: torch.Tensor) -> torch.Tensor:
        """erp's boundary prefix ``cumsum_k d(x_k, g)`` along the last
        axis, in float32."""
        return torch.cumsum(self.cell_cost(x, self.gap), dim=-1)

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
                 family: str | None = None, nu: float | None = None,
                 lam: float | None = None, gap: float | None = None,
                 gap_penalty: float | None = None,
                 match_reward: float | None = None) -> DPSpec:
    """Merge per-call overrides over an optional base spec; ``gamma``
    alone implies ``reduction="softmin"``, as in ``repro``."""
    base = spec if spec is not None else DEFAULT_SPEC
    if gamma is not None and reduction is None:
        reduction = "softmin"
    updates = {k: v for k, v in [("distance", distance),
                                 ("reduction", reduction),
                                 ("gamma", gamma), ("band", band),
                                 ("family", family), ("nu", nu),
                                 ("lam", lam), ("gap", gap),
                                 ("gap_penalty", gap_penalty),
                                 ("match_reward", match_reward)]
               if v is not None}
    return dataclasses.replace(base, **updates) if updates else base


def previous_samples(x: torch.Tensor) -> torch.Tensor:
    """twed's shifted series ``x[k-1]`` along the last axis, with the
    ``x[-1] = 0`` convention."""
    return torch.nn.functional.pad(x[..., :-1], (1, 0))


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
