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

The non-sdtw families (twed / erp / local) take the same sweep with
every cell through ``DPSpec.family_cell`` (:func:`_dp_engine`): K7's
plain version.  ``compute_dtype=torch.bfloat16`` runs the hard-min sdtw
sweep with bf16 cells and carries (every operation computed in float32
and rounded to bf16, as torch's bf16 ops are) and a float32 fold: the
plain version of bf16-K1.

Complexity: (M + N - 1) steps of O(B·M) work.
"""

from __future__ import annotations

import torch

from repro_torch.core.ref import J_MAX
from repro_torch.core.spec import (DEFAULT_SPEC, INF, NO_WINDOW, SOFT_BIG,
                                   DPSpec, previous_samples)


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
                n_valid: int | None = None, return_bottom: bool = False,
                extras: tuple | None = None,
                compute_dtype: torch.dtype = torch.float32):
    """Batched anti-diagonal sDTW under ``spec``.

    queries:   (B, M) float32
    reference: (N,) float32, shared across the batch
    return_window: also propagate the start column through the sweep
               (``spec.start3``); returns (costs, starts, ends)
    n_valid:   fold only the bottom-row cells with j < n_valid (the
               plain wavefront sweeps a zero-padded layout and folds
               the true columns only); default N
    return_bottom: also return the (B, n_valid) bottom row D[M-1, :]
    extras:    a family's operands as ``kernels.ops.family_extras``
               lays them out (twed ``(r_prev,)``, erp ``(bt, bl)``);
               default: computed here from ``reference`` and ``queries``
    compute_dtype: the hard-min sdtw sweep's cells and carries:
               float32, or bfloat16 (bf16-K1's plain version; the plan
               rules are ``kernels.wavefront.check_plan``'s)
    returns:   (costs (B,), ends (B,) int32), or (costs, starts, ends),
               with the bottom row appended when ``return_bottom``
    """
    spec = DEFAULT_SPEC if spec is None else spec
    if return_window and spec.soft:
        raise ValueError("return_window needs a hard-min spec: soft-min "
                         "has no argmin path")
    if spec.family != "sdtw":
        if return_bottom:
            raise ValueError("return_bottom is an sdtw bottom-row output")
        return _dp_engine(queries.to(torch.float32),
                          reference.to(torch.float32), spec=spec,
                          return_window=return_window, n_valid=n_valid,
                          extras=extras)
    q = queries.to(compute_dtype)
    r = reference.to(compute_dtype)
    B, M = q.shape
    N = r.shape[0]
    nv = N if n_valid is None else n_valid
    dev = q.device
    # reversed + padded reference: diagonal t reads the contiguous slice
    # r_ext[N-1-t+M-1 : ... + M], whose element i is r[t - i]
    r_ext = torch.nn.functional.pad(torch.flip(r, (0,)), (M - 1, M - 1))
    row0 = (torch.arange(M, device=dev) == 0)

    big = spec.big
    d1 = torch.full((B, M), big, dtype=compute_dtype, device=dev)
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
            cand = d0[:, M - 1].float()
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


# diagonals one captured CUDA graph of the family sweep advances: d1 / d2
# rotate through three fixed buffers and come back to their places
GRAPH_DIAGONALS = 3


def _dp_engine(q: torch.Tensor, r: torch.Tensor, *, spec: DPSpec,
               return_window: bool, n_valid: int | None, extras,
               _graph: bool = False):
    """Anti-diagonal sweep of the non-sdtw families (the counterpart of
    ``repro.core.engine._dp_engine``) and K7's plain version: the same
    rotating diagonals as :func:`sdtw_engine`, every cell through
    ``spec.family_cell``, and the family's fold over the true columns
    ``j < n_valid`` only (the kernel's zero-padded layout computes pad
    columns and never folds them):

    * corner (twed / erp): ``D[M-1, n_valid-1]``; a masked or unreached
      corner gives ``(inf, 0)``;
    * cells (local): the lexicographic ``(value, column)`` minimum over
      every valid cell below ``big / 2``, and under soft-min a running
      logsumexp of ``-D / gamma`` beside it.

    One diagonal's body (``diagonal``) takes its index ``t`` as a Python
    int or as a (1,) int64 tensor on the device, and reads the reference
    windows with ``unfold`` and ``index_select``.  With ``_graph``
    (K7's plain version on the card, ``kernels.family.family_plain``, and
    the tests) the steady stretch, where every row is live and no fold
    edge falls (unbanded, diagonals ``M - 1 <= t < min(N, n_valid) - 1``),
    runs with ``t`` on the device, ``GRAPH_DIAGONALS`` diagonals at a
    time, rotating d1 / d2 through fixed buffers: on a CUDA tensor that
    block is captured once as a CUDA graph on the tensor's own device
    and replayed, so the host no longer paces one launch per operation
    (on the CPU the same block runs eagerly).  The capture synchronizes
    the device and empties the allocator's cache, so ``sdtw_engine``
    leaves it off and sweeps every diagonal eagerly.  The arithmetic is
    the same operations on the same operands, so both ways give the
    same bits.
    """
    fam = spec.family
    local = fam == "local"
    if return_window and local:
        raise ValueError(
            "return_window is undefined for the local family: a local "
            "alignment's span needs a full backtrack, not a start lane")
    B, M = q.shape
    N = r.shape[0]
    nv = N if n_valid is None else n_valid
    dev = q.device
    big = spec.big
    if extras is None:
        if fam == "twed":
            extras = (previous_samples(r),)
        elif fam == "erp":
            extras = (spec.gap_prefix(r), spec.gap_prefix(q))
        else:
            extras = ()

    def windows(x):
        """Reversed + padded, one row per diagonal: row ``start`` holds
        ``x[t - i]`` at position i."""
        return torch.nn.functional.pad(torch.flip(x, (0,)),
                                       (M - 1, M - 1)).unfold(0, M, 1)

    r_win = windows(r)
    rp_win = bt_win = q_prev = bl = None
    if fam == "twed":
        rp_win = windows(extras[0][:N])
        q_prev = previous_samples(q)
    elif fam == "erp":
        bt_win, bl = windows(extras[0][:N]), extras[1]
    ii = torch.arange(M, device=dev)
    row0 = ii == 0

    def diagonal(t, lo, hi, fold, corner, d1, d2, best, best_j, m_run,
                 s_run):
        """Diagonal t: rows [lo, hi] live, ``fold`` the local fold's rows
        (lo_f, hi_f) or None, ``corner`` whether it holds the corner.
        Returns the new diagonal and the folds."""
        start = (N - 1 + M - 1) - t

        def at(win):
            return win[start] if isinstance(start, int) \
                else win.index_select(0, start).squeeze(0)
        j = t - ii
        d0 = spec.family_cell(
            q, at(r_win), d1, torch.roll(d1, 1, -1), torch.roll(d2, 1, -1),
            i=ii, j=j, is_row0=row0, is_col0=j == 0, q_prev=q_prev,
            r_prev=None if rp_win is None else at(rp_win),
            top_boundary=None if bt_win is None else at(bt_win),
            left_boundary=bl)
        _mask_outside(d0, lo, hi, big)
        if fold is not None:
            # fold the true columns only; diagonals ascend in t, so an
            # equal (value, column) keeps the first-seen row
            lo_f, hi_f = fold
            cells = d0[:, lo_f:hi_f + 1]
            cols = j[lo_f:hi_f + 1]
            v = cells.min(dim=1).values
            jm = torch.where(cells == v[:, None], cols,
                             J_MAX).min(dim=1).values
            take = ((v < best) | ((v == best) & (jm < best_j))) \
                & (v < big / 2)
            best = torch.where(take, v, best)
            best_j = torch.where(take, jm, best_j)
            if spec.soft:
                x = -cells / spec.gamma     # masked cells weigh 0
                m_new = torch.maximum(m_run, x.max(dim=1).values)
                s_run = s_run * torch.exp(m_run - m_new) \
                    + torch.exp(x - m_new[:, None]).sum(dim=1)
                m_run = m_new
        elif corner:
            cand = d0[:, M - 1]
            take = cand < best          # a masked corner never takes
            best = torch.where(take, cand, best)
            best_j = torch.where(take, nv - 1, best_j)
        return d0, best, best_j, m_run, s_run

    def steady_run(t0, count, d1, d2, *folds):
        """``count`` (a multiple of GRAPH_DIAGONALS) steady diagonals from
        t0, with t on the device: d2, d1 and the new diagonal in three
        fixed buffers, the folds updated in place."""
        bufs = [d2.clone(), d1.clone(), torch.empty_like(d1)]
        acc = [x.clone() for x in folds]
        t_dev = torch.full((1,), t0, dtype=torch.int64, device=dev)
        fold = (0, M - 1) if local else None

        def block():
            out = list(acc)
            for k in range(GRAPH_DIAGONALS):
                d0, *out = diagonal(t_dev, 0, M - 1, fold, False,
                                    bufs[(k + 1) % 3], bufs[k], *out)
                bufs[(k + 2) % 3].copy_(d0)
                t_dev.add_(1)
            for x, y in zip(acc, out):
                x.copy_(y)
        if dev.type == "cuda":
            # on the tensors' device, whichever is current, with a capture
            # stream there; errors only for this thread's unsafe calls
            with torch.cuda.device(dev):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, stream=torch.cuda.Stream(dev),
                                      capture_error_mode="thread_local"):
                    block()
                for _ in range(count // GRAPH_DIAGONALS):
                    g.replay()
                del g
        else:
            for _ in range(count // GRAPH_DIAGONALS):
                block()
        return (bufs[1], bufs[0], *acc)

    t_a = M - 1
    n_steady = 0
    if _graph and spec.band is None:
        n_steady = max(0, min(N, nv) - 1 - t_a) // GRAPH_DIAGONALS \
            * GRAPH_DIAGONALS
    d1 = torch.full((B, M), big, dtype=torch.float32, device=dev)
    d2 = d1
    folds = (torch.full((B,), big, dtype=torch.float32, device=dev),
             torch.full((B,), J_MAX if local else 0, dtype=torch.int64,
                        device=dev),
             torch.full((B,), -INF, dtype=torch.float32, device=dev),
             torch.zeros((B,), dtype=torch.float32, device=dev))
    corner_t = (M - 1) + (nv - 1)
    t = 0
    while t < M + N - 1:
        if t == t_a and n_steady:
            d1, d2, *folds = steady_run(t, n_steady, d1, d2, *folds)
            t += n_steady
            continue
        lo, hi = _valid_rows(t, M, N, spec.band)
        fold = None
        if local and max(lo, t - nv + 1) <= hi:
            fold = (max(lo, t - nv + 1), hi)
        d0, *folds = diagonal(t, lo, hi, fold,
                              not local and t == corner_t, d1, d2, *folds)
        d2, d1 = d1, d0
        t += 1
    best, best_j, m_run, s_run = folds
    if local:
        cost = (-spec.gamma * (m_run + torch.log(s_run)) if spec.soft
                else best)
    else:
        blocked = best >= big / 2
        cost = torch.where(blocked, INF, best)
        best_j = torch.where(blocked, 0, best_j)
    end = best_j.to(torch.int32)
    if return_window:
        start = torch.where(torch.isinf(cost), NO_WINDOW, 0).to(torch.int32)
        return cost, start, end
    return cost, end
