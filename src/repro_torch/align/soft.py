"""Soft alignment — the smoothed analogue of windows and paths.

Soft-min specs have no argmin path: every monotone alignment contributes
with Gibbs weight ``exp(-cost / gamma)``.  The expected alignment

    E[i, j] = d sdtw_gamma / d C[i, j] = P(the alignment visits (i, j))

is obtained here with ``torch.autograd`` straight through an
anti-diagonal sweep that takes the cost matrix as an explicit input.
Each query row carries mass >= 1, and as gamma -> 0 E tends to the
indicator of the hard optimal path.  Counterpart of
``repro.align.soft``; ``backend="kernel"`` runs the fused K6 pair and
tile pass of ``repro_torch.kernels.backward`` instead.
"""

from __future__ import annotations

import torch

from repro_torch.core.device import as_f32, resolve_device
from repro_torch.core.normalize import normalize_batch
from repro_torch.core.spec import (DEFAULT_SPEC, INF, DPSpec, resolve_spec,
                                   validate_batch_inputs)


def soft_costs(queries, reference, *, spec: DPSpec | None = None,
               gamma: float | None = None, backend: str | None = None,
               normalize: bool = True, band: int | None = None,
               segment_width: int = 8, device=None):
    """Batched soft-min sDTW (costs (B,), ends (B,)) through the front
    door; a hard-min spec is promoted to soft-min with its gamma."""
    from repro_torch.core.api import sdtw
    resolved = resolve_spec(spec, gamma=gamma, band=band)
    if not resolved.soft:
        resolved = resolve_spec(resolved, reduction="softmin")
    res = sdtw(queries, reference, outputs=("cost", "end"),
               normalize=normalize, backend=backend, spec=resolved,
               segment_width=segment_width, device=device)
    return res.cost, res.end


def cost_matrix(queries: torch.Tensor, reference: torch.Tensor,
                spec: DPSpec = DEFAULT_SPEC) -> torch.Tensor:
    """(B, M) x (N,) -> the (B, M, N) local cost tensor under the spec."""
    return spec.cell_cost(queries[:, :, None], reference[None, None, :])


def sdtw_soft_from_costs(C: torch.Tensor, *, spec: DPSpec) -> torch.Tensor:
    """Soft-min sDTW costs (B,) from an explicit (B, M, N) cost tensor:
    the engine's recurrence, free start and logsumexp readout, made
    differentiable with respect to ``C`` itself."""
    if not spec.soft:
        raise ValueError("sdtw_soft_from_costs needs a softmin spec")
    B, M, N = C.shape
    big = spec.big
    dev = C.device
    ii = torch.arange(M, device=dev)
    jj = torch.arange(M + N - 1, device=dev)[None, :] - ii[:, None]
    Cs = C.gather(2, jj.clamp(0, N - 1).expand(B, M, -1))
    valid = (jj >= 0) & (jj < N)
    in_band = spec.band_valid(ii[:, None], jj)
    if in_band is not None:
        valid = valid & in_band
    d1 = torch.full((B, M), big, device=dev)
    d2 = d1
    bottoms = []
    for t in range(M + N - 1):
        up = torch.roll(d1, 1, -1)
        upleft = torch.roll(d2, 1, -1)
        d0 = spec.cell_update(Cs[:, :, t], d1, up, upleft,
                              free_start=ii == 0)
        d0 = torch.where(valid[:, t], d0, big)
        if t >= M - 1:
            bottoms.append(d0[:, M - 1])
        d2, d1 = d1, d0
    bottom = torch.stack(bottoms, dim=1)                      # (B, N)
    cost = -spec.gamma * torch.logsumexp(-bottom / spec.gamma, dim=1)
    # the band blocks the whole bottom row: no alignment, +inf (and the
    # where zeroes the gradient of that row)
    blocked = bottom.min(dim=1).values >= big / 2
    return torch.where(blocked, INF, cost)


def expected_alignment_from(queries: torch.Tensor, reference: torch.Tensor,
                            spec: DPSpec) -> torch.Tensor:
    """E (B, M, N) of already-normalized operands: the gradient of the
    summed soft costs with respect to the cost matrix."""
    with torch.enable_grad():
        C = cost_matrix(queries.detach(), reference.detach(),
                        spec).requires_grad_()
        (E,) = torch.autograd.grad(sdtw_soft_from_costs(C, spec=spec).sum(),
                                   C)
    return E


def expected_alignment(queries, reference, *, spec: DPSpec | None = None,
                       normalize: bool = True, backend: str | None = None,
                       segment_width: int = 8, device=None) -> torch.Tensor:
    """The (B, M, N) expected alignment matrices of a softmin spec.
    ``backend=None`` or ``"engine"`` differentiates the cost-matrix
    sweep; ``"kernel"`` runs the fused K6 pair and tile pass."""
    spec = DEFAULT_SPEC if spec is None else spec
    if not spec.soft:
        raise ValueError(
            "expected_alignment needs a softmin spec (reduction="
            "'softmin'); hard-min alignment lives in repro.align.window "
            "/ repro.align.traceback")
    if backend not in (None, "engine", "kernel"):
        raise ValueError(f"expected_alignment backend must be None, "
                         f"'engine' or 'kernel', got {backend!r}")
    dev = resolve_device(device)
    q = as_f32(queries, dev)
    r = as_f32(reference, dev)
    validate_batch_inputs(q, r)
    if normalize:
        q = normalize_batch(q)
        r = normalize_batch(r)
    if backend == "kernel":
        from repro_torch.kernels.backward import soft_alignment_fused
        return soft_alignment_fused(q, r, spec=spec,
                                    segment_width=segment_width)[2]
    return expected_alignment_from(q, r, spec)


def row_position_distribution(E: torch.Tensor) -> torch.Tensor:
    """Normalize E per query row into a distribution over reference
    columns (each (b, i) row sums to 1)."""
    return E / torch.clamp(E.sum(dim=-1, keepdim=True), min=1e-30)
