"""Reference (oracle) implementations of subsequence DTW for the port.

* :func:`sdtw_numpy` — the float64 full-matrix oracle, a copy of
  ``repro.core.ref.sdtw_numpy`` (hard- and soft-min): the shared judge
  where the float32 paths disagree.
* :func:`sdtw_ref` — a row-by-row scan in torch, the counterpart of
  ``repro.core.ref.sdtw_ref``.  Sequential over both axes (vectorized
  over the batch only), so it is slow and meant for test-size inputs.

Recurrence, 0-based rows ``i`` and columns ``j``::

    D[i, j] = cost(q[i], r[j]) + reduce(D[i-1, j], D[i, j-1], D[i-1, j-1])

with ``D[-1, j] = 0`` (an alignment may start anywhere) and
``D[i, -1] = inf``; the answer is the reduction (min, or the soft-min
``-gamma * logsumexp(-x / gamma)``) of ``D[M-1, j]`` over j.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spec import (DEFAULT_SPEC, INF, NO_WINDOW, SOFT_BIG,
                                   DPSpec, previous_samples)

J_MAX = 2 ** 31 - 1
#   The local fold's "no column yet" sentinel: any real column beats it.


def _np_cost(spec: DPSpec, a: float, b: float) -> float:
    if spec.distance == "sqeuclidean":
        return (a - b) ** 2
    if spec.distance == "abs":
        return abs(a - b)
    return 1.0 - (a * b) / (abs(a) * abs(b) + 1e-8)


def _np_logsumexp(a: np.ndarray) -> float:
    mx = np.max(a)
    if not np.isfinite(mx):
        return -np.inf
    return float(mx + np.log(np.sum(np.exp(a - mx))))


def _np_softmin(vals, gamma: float) -> float:
    a = -np.asarray(vals, dtype=np.float64) / gamma
    if not np.isfinite(np.max(a)):          # every predecessor blocked
        return np.inf
    return -gamma * _np_logsumexp(a)


def sdtw_numpy(q: np.ndarray, r: np.ndarray,
               spec: DPSpec | None = None) -> tuple[float, int]:
    """Brute-force full-matrix sDTW in float64.  O(M*N) memory.
    Returns (cost, end_index); under soft-min the cost is the soft-min
    over the bottom row and the end its hard argmin."""
    spec = DEFAULT_SPEC if spec is None else spec
    q = np.asarray(q, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    m, n = len(q), len(r)
    D = np.full((m + 1, n + 1), np.inf, dtype=np.float64)
    D[0, :] = 0.0  # subsequence: free start anywhere in the reference
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if spec.band is not None and abs((i - 1) - (j - 1)) > spec.band:
                continue                      # out of band: stays +inf
            c = _np_cost(spec, q[i - 1], r[j - 1])
            preds = (D[i, j - 1], D[i - 1, j], D[i - 1, j - 1])
            if i == 1:
                prev = 0.0                    # free start: D[-1, j] == 0
            elif spec.soft:
                prev = _np_softmin(preds, spec.gamma)
            else:
                prev = min(preds)
            D[i, j] = c + prev
    last = D[m, 1:]
    end = int(np.argmin(last))
    if spec.soft:
        return -spec.gamma * _np_logsumexp(-last / spec.gamma), end
    return float(last[end]), end


def sdtw_ref(queries: torch.Tensor, reference: torch.Tensor,
             spec: DPSpec | None = None, *, return_window: bool = False):
    """Batched row-scan sDTW oracle.

    queries: (B, M) float32; reference: (N,) float32.
    Returns (costs (B,), ends (B,) int32), or (costs, starts, ends) when
    ``return_window`` (hard-min only).  Differentiable under soft-min.
    """
    spec = DEFAULT_SPEC if spec is None else spec
    if return_window and spec.soft:
        raise ValueError("return_window needs a hard-min spec: soft-min "
                         "has no argmin path")
    if spec.family != "sdtw":
        return _dp_rowscan(queries.to(torch.float32),
                           reference.to(torch.float32), spec,
                           return_window)
    q = queries.to(torch.float32)
    r = reference.to(torch.float32)
    B, M = q.shape
    N = r.shape[0]
    dev = q.device
    jj = torch.arange(N, device=dev)
    ok = spec.band_valid(torch.arange(M, device=dev)[:, None], jj[None])

    # row 0: the free start makes every cell its own cost
    row = spec.cell_cost(q[:, :1], r[None])
    starts = jj.to(torch.int32).expand(B, N).clone()
    if ok is not None:
        row = torch.where(ok[0], row, spec.big)
        starts = torch.where(ok[0], starts, NO_WINDOW)
    big = torch.full((B,), spec.big, dtype=torch.float32, device=dev)
    neg = torch.full((B,), NO_WINDOW, dtype=torch.int32, device=dev)
    for i in range(1, M):
        cost = spec.cell_cost(q[:, i:i + 1], r[None])
        new_row = torch.empty_like(row)
        new_starts = torch.empty_like(starts)
        left, upleft, s_left, s_upleft = big, big, neg, neg
        for j in range(N):
            up, s_up = row[:, j], starts[:, j]
            if ok is not None and not bool(ok[i, j]):
                val, s = big, neg
            else:
                val = spec.cell_update(cost[:, j], left, up, upleft)
                s = (spec.start3(left, up, upleft, s_left, s_up, s_upleft)
                     if return_window else s_left)
            new_row[:, j] = val
            new_starts[:, j] = s
            left, upleft, s_left, s_upleft = val, up, s, s_up
        row, starts = new_row, new_starts
    # torch.argmin returns the first minimal index: earliest column wins
    end = torch.argmin(row, dim=1)
    cost = row.gather(1, end[:, None])[:, 0]
    if spec.soft:
        soft = -spec.gamma * torch.logsumexp(-row / spec.gamma, dim=1)
        # the band masks the whole bottom row: +inf, as the hard path
        return torch.where(cost >= SOFT_BIG / 2, INF, soft), \
            end.to(torch.int32)
    if return_window:
        start = starts.gather(1, end[:, None])[:, 0]
        return cost, start, end.to(torch.int32)
    return cost, end.to(torch.int32)


def _dp_rowscan(q: torch.Tensor, r: torch.Tensor, spec: DPSpec,
                return_window: bool):
    """Row-by-row scan of the non-sdtw families (twed / erp / local),
    batched over the queries: the counterpart of
    ``repro.core.ref._dp_rowscan_single``.  Every cell goes through
    ``spec.family_cell``; the fold follows ``spec.recurrence.fold``:

    * ``corner`` (twed / erp): ``D[m-1, n-1]``; a band that disconnects
      the corner gives ``(inf, 0)`` (and start ``NO_WINDOW``);
    * ``cells`` (local): the lexicographic ``(value, column)`` minimum
      over every valid cell (hard), or the logsumexp over them with the
      hard minimizer's column as the end (soft).
    """
    fam = spec.family
    local = fam == "local"
    if return_window and local:
        raise ValueError(
            "return_window is undefined for the local family: a local "
            "alignment's span needs a full backtrack, not a start lane")
    B, M = q.shape
    N = r.shape[0]
    dev = q.device
    big = spec.big
    jj = torch.arange(N, device=dev)
    zero_r, zero_q = torch.zeros_like(r), torch.zeros_like(q)
    r_prev, q_prev, bt, bl = zero_r, zero_q, zero_r, zero_q
    if fam == "twed":
        r_prev, q_prev = previous_samples(r), previous_samples(q)
    elif fam == "erp":
        bt, bl = spec.gap_prefix(r), spec.gap_prefix(q)
    ok = spec.band_valid(torch.arange(M, device=dev)[:, None], jj[None])
    row = torch.full((B, N), big, dtype=torch.float32, device=dev)
    best = torch.full((B,), big, dtype=torch.float32, device=dev)
    best_j = torch.full((B,), J_MAX, dtype=torch.int64, device=dev)
    mx = torch.full((B,), -INF, dtype=torch.float32, device=dev)
    s = torch.zeros((B,), dtype=torch.float32, device=dev)
    big_b = torch.full((B,), big, dtype=torch.float32, device=dev)
    for i in range(M):
        new_row = torch.empty_like(row)
        left, upleft = big_b, big_b
        ti = torch.tensor(i, device=dev)
        for j in range(N):
            up = row[:, j]
            if ok is not None and not bool(ok[i, j]):
                val = big_b
            else:
                tj = torch.tensor(j, device=dev)
                val = spec.family_cell(
                    q[:, i], r[j], left, up, upleft, i=ti, j=tj,
                    is_row0=ti == 0, is_col0=tj == 0, q_prev=q_prev[:, i],
                    r_prev=r_prev[j], top_boundary=bt[j],
                    left_boundary=bl[:, i])
            new_row[:, j] = val
            left, upleft = val, up
        row = new_row
        if local:
            # rows ascend, so an equal (value, column) keeps the first row
            v = row.min(dim=1).values
            jm = torch.where(row == v[:, None], jj, J_MAX).min(dim=1).values
            take = (v < best) | ((v == best) & (jm < best_j))
            best = torch.where(take, v, best)
            best_j = torch.where(take, jm, best_j)
            if spec.soft:
                x = -row / spec.gamma       # masked cells weigh 0
                m_new = torch.maximum(mx, x.max(dim=1).values)
                s = s * torch.exp(mx - m_new) \
                    + torch.exp(x - m_new[:, None]).sum(dim=1)
                mx = m_new
    if local:
        end = best_j.to(torch.int32)
        if spec.soft:
            return -spec.gamma * (mx + torch.log(s)), end
        return best, end
    corner = row[:, N - 1]
    blocked = corner >= big / 2 if spec.soft else torch.isinf(corner)
    cost = torch.where(blocked, INF, corner)
    end = torch.where(blocked, 0, N - 1).to(torch.int32)
    if return_window:
        start = torch.where(blocked, NO_WINDOW, 0).to(torch.int32)
        return cost, start, end
    return cost, end
