"""Anti-diagonal (wavefront) sDTW engine in torch — the port's non-kernel
backend and the plain version the CUDA wavefront is held against.

The DP matrix is swept along anti-diagonals t = i + j.  Every cell of a
diagonal is independent, so each step is a handful of (B, M) tensor ops;
two rotating diagonals play the role of the paper's double buffers.
Counterpart of ``repro.core.engine.sdtw_engine`` for sdtw specs (hard-
and soft-min) with a shared 1-D reference.

Hard-min cells round exactly as the CUDA wavefront's (``d * d`` then one
add, min is exact), so on identical inputs the two agree bit for bit;
``INF`` here and ``KERNEL_BIG`` there never win a valid cell's min.
Soft-min cells use the min-shifted logsumexp of ``DPSpec.reduce3`` with
the finite ``SOFT_BIG`` sentinel, and the bottom row is folded by a
running-max logsumexp of ``-D[M-1, j] / gamma`` beside the hard
(min, argmin) twin that gives ``end`` and detects a blocked band
(``+inf``).  The soft sweep is differentiable under ``torch.autograd``:
the masks write in place only into a freshly computed diagonal, which
no backward function has saved.

Complexity: (M + N - 1) steps of O(B·M) work.
"""

from __future__ import annotations

import torch

from repro_torch.core.spec import (DEFAULT_SPEC, INF, NO_WINDOW, SOFT_BIG,
                                   DPSpec)


def _valid_rows(t: int, m: int, n: int, band: int | None):
    """Rows i of diagonal t whose cell (i, t - i) lies in the grid (and
    the band): one contiguous range [lo, hi], empty when lo > hi."""
    lo, hi = max(0, t - n + 1), min(m - 1, t)
    if band is not None:
        # |i - (t - i)| <= band  <=>  ceil((t - band) / 2) <= i
        #                              <= floor((t + band) / 2)
        lo = max(lo, -((band - t) // 2))
        hi = min(hi, (t + band) // 2)
    return lo, hi


def _mask_outside(x: torch.Tensor, lo: int, hi: int, value) -> None:
    """In place: x[:, i] = value for every row i outside [lo, hi]."""
    if lo > hi:
        x.fill_(value)
        return
    if lo > 0:
        x[:, :lo] = value
    if hi < x.shape[1] - 1:
        x[:, hi + 1:] = value


def sdtw_engine(queries: torch.Tensor, reference: torch.Tensor, *,
                spec: DPSpec | None = None, return_window: bool = False,
                n_valid: int | None = None, return_bottom: bool = False):
    """Batched anti-diagonal sDTW under ``spec``.

    queries:   (B, M) float32
    reference: (N,) float32, shared across the batch
    return_window: also propagate the start column through the sweep
               (``spec.start3``); returns (costs, starts, ends)
    n_valid:   fold only the bottom-row cells with j < n_valid (the
               plain wavefront sweeps a zero-padded layout and folds
               the true columns only); default N
    return_bottom: also return the (B, n_valid) bottom row D[M-1, :]
    returns:   (costs (B,), ends (B,) int32), or (costs, starts, ends),
               with the bottom row appended when ``return_bottom``
    """
    spec = DEFAULT_SPEC if spec is None else spec
    if return_window and spec.soft:
        raise ValueError("return_window needs a hard-min spec: soft-min "
                         "has no argmin path")
    q = queries.to(torch.float32)
    r = reference.to(torch.float32)
    B, M = q.shape
    N = r.shape[0]
    nv = N if n_valid is None else n_valid
    dev = q.device
    # reversed + padded reference: diagonal t reads the contiguous slice
    # r_ext[N-1-t+M-1 : ... + M], whose element i is r[t - i]
    r_ext = torch.nn.functional.pad(torch.flip(r, (0,)), (M - 1, M - 1))
    row0 = (torch.arange(M, device=dev) == 0)

    big = spec.big
    d1 = torch.full((B, M), big, dtype=torch.float32, device=dev)
    d2 = d1.clone()
    best = torch.full((B,), big, dtype=torch.float32, device=dev)
    best_j = torch.zeros((B,), dtype=torch.int32, device=dev)
    if spec.soft:
        m_run = torch.full((B,), -SOFT_BIG, dtype=torch.float32, device=dev)
        s_run = torch.zeros((B,), dtype=torch.float32, device=dev)
    if return_bottom:
        bottom = torch.full((B, nv), big, dtype=torch.float32, device=dev)
    if return_window:
        s1 = torch.full((B, M), NO_WINDOW, dtype=torch.int32, device=dev)
        s2 = s1.clone()
        best_s = torch.full((B,), NO_WINDOW, dtype=torch.int32, device=dev)

    for t in range(M + N - 1):
        lo, hi = _valid_rows(t, M, N, spec.band)
        start = N - 1 - t + (M - 1)
        cost = spec.cell_cost(q, r_ext[start:start + M])
        up = torch.roll(d1, 1, -1)
        upleft = torch.roll(d2, 1, -1)
        # cell (i, t-i): left = d1[i], up = d1[i-1], upleft = d2[i-1]
        d0 = spec.cell_update(cost, d1, up, upleft, free_start=row0)
        _mask_outside(d0, lo, hi, big)
        if return_window:
            s0 = spec.start3(d1, up, upleft, s1, torch.roll(s1, 1, -1),
                             torch.roll(s2, 1, -1))
            s0[:, 0] = t                  # row 0 begins at its column
            _mask_outside(s0, lo, hi, NO_WINDOW)
        j_bottom = t - (M - 1)
        # soft-min folds every bottom cell of the true columns (a cell the
        # band masks weighs exp(-big / gamma) = 0) so that the cost stays
        # on the autograd graph even when the band blocks them all
        if 0 <= j_bottom < nv and (spec.soft or lo <= M - 1 <= hi):
            cand = d0[:, M - 1]
            take = cand < best            # strict: earliest column wins
            best = torch.where(take, cand, best)
            best_j = torch.where(take, j_bottom, best_j)
            if return_window:
                best_s = torch.where(take, s0[:, M - 1], best_s)
            if spec.soft:
                x = -cand / spec.gamma
                m_new = torch.maximum(m_run, x)
                s_run = (s_run * torch.exp(m_run - m_new)
                         + torch.exp(x - m_new))
                m_run = m_new
            if return_bottom:
                bottom[:, j_bottom] = cand
        d2, d1 = d1, d0
        if return_window:
            s2, s1 = s1, s0
    if spec.soft:
        # no reachable bottom cell (the band blocks the whole bottom
        # row): +inf as on the hard path.  The logsumexp is taken of
        # safe values there, so the gradient is 0, not 0 * inf = NaN.
        blocked = best >= SOFT_BIG / 2
        m_run = torch.where(blocked, 0.0, m_run)
        s_run = torch.where(blocked, 1.0, s_run)
        best = torch.where(blocked, INF,
                           -spec.gamma * (m_run + torch.log(s_run)))
    out = (best, best_s, best_j) if return_window else (best, best_j)
    return out + (bottom,) if return_bottom else out
