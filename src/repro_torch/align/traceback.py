"""Full warping-path extraction in O(M + N) memory.

Counterpart of ``repro.align.traceback``.  A matched window pins both
ends of the alignment: within ``reference[start : end + 1]`` the
subsequence problem becomes a GLOBAL DTW between the query and the
window (row 0 of the sDTW matrix admits no left-moves — ``D[0, j] =
cost(0, j)`` exactly — so a path's first cell is ``(0, start)`` and its
last is ``(M-1, end)``).  The path is then recovered Hirschberg-style:
split the query rows in half, meet a forward cost sweep from the pinned
start and a backward sweep from the pinned end at the split row, pick
the crossing column, and recurse on the two sub-rectangles.  Every sweep
is an anti-diagonal linear-memory pass in numpy float64 on the host (the
oracle's precision), total work O(M·N) and memory O(M + N) — the matrix
is never materialized.

The window comes from the card: ``repro_torch.sdtw(...,
outputs=("cost", "start", "end"))`` runs K2 on both operands and K3 (K4
with the start lane under a band).  The traceback itself is host work,
as in the reference, where it is no TPU kernel either.

Small sub-problems bottom out in a full-matrix backtrack that uses the
SAME tie-break contract as ``DPSpec.start3`` / ``repro_torch.align.
oracle``, so on tie-free data the divide-and-conquer path equals the
full-matrix oracle path cell for cell.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import as_f32, resolve_device
from repro_torch.core.normalize import normalize_batch
from repro_torch.core.ref import _np_cost
from repro_torch.core.spec import DEFAULT_SPEC, DPSpec

# sub-problems at most this many cells use the full-matrix base case
# (bounded, so Hirschberg's O(M + N) memory claim survives)
_BASE_CELLS = 2048


def _band_ok(spec: DPSpec, gi, gj):
    """Global Sakoe–Chiba validity of (query row gi, ref column gj)."""
    if spec.band is None:
        return None
    return np.abs(gi - gj) <= spec.band


def _pinned_lastrow(qs, ws, spec, i0, j0, flipped):
    """Last row of the pinned-start global DTW over a sub-rectangle.

    qs: (R,) query rows; ws: (C,) reference columns; (i0, j0): the
    rectangle's GLOBAL top-left (band masks are global).  ``flipped``
    runs the reversed sweep for the backward pass: local cell (i, j)
    then denotes global (i0 + R-1-i, j0 + C-1-j).

    Anti-diagonal numpy sweep — O(R) vector work per step, O(R + C)
    memory, float64 (the oracle's precision).
    Returns lastrow (C,): lastrow[j] = best path cost (0,0) -> (R-1, j),
    both endpoint cell costs included.
    """
    R, C = len(qs), len(ws)
    ii = np.arange(R)
    d1 = np.full(R, np.inf)
    d2 = np.full(R, np.inf)
    lastrow = np.full(C, np.inf)
    for t in range(R + C - 1):
        j = t - ii
        valid = (j >= 0) & (j < C)
        jc = np.clip(j, 0, C - 1)
        if spec.band is not None:
            if flipped:
                ok = _band_ok(spec, i0 + R - 1 - ii, j0 + C - 1 - jc)
            else:
                ok = _band_ok(spec, i0 + ii, j0 + jc)
            valid &= ok
        # _np_cost's expressions broadcast over numpy arrays as-is
        cost = _np_cost(spec, qs, ws[jc])
        up = np.concatenate(([np.inf], d1[:-1]))
        upleft = np.concatenate(([np.inf], d2[:-1]))
        prev = np.minimum(np.minimum(d1, up), upleft)
        if t == 0:
            prev = prev.copy()
            prev[0] = 0.0                      # the pinned start (0, 0)
        d0 = np.where(valid, cost + prev, np.inf)
        if t >= R - 1 and t - (R - 1) < C:
            lastrow[t - (R - 1)] = d0[R - 1]
        d2, d1 = d1, d0
    return lastrow


def _small_path(qs, ws, spec, i0, j0):
    """Full-matrix pinned-corners backtrack (the recursion's base case).
    Returns local (i, j) cells from (0, 0) to (R-1, C-1), using the
    shared start3 tie-break (upleft needs STRICT <, up beats left only
    on STRICT <)."""
    R, C = len(qs), len(ws)
    D = np.full((R, C), np.inf)
    ok = _band_ok(spec, i0 + np.arange(R)[:, None],
                  j0 + np.arange(C)[None, :])
    for i in range(R):
        for j in range(C):
            if ok is not None and not ok[i, j]:
                continue
            c = _np_cost(spec, qs[i], ws[j])
            if i == 0:
                D[i, j] = c if j == 0 else c + D[0, j - 1]
            else:
                left = D[i, j - 1] if j > 0 else np.inf
                upleft = D[i - 1, j - 1] if j > 0 else np.inf
                D[i, j] = c + min(left, D[i - 1, j], upleft)
    i, j = R - 1, C - 1
    cells = [(i, j)]
    while (i, j) != (0, 0):
        if i == 0:
            i, j = 0, j - 1
        else:
            left = D[i, j - 1] if j > 0 else np.inf
            up = D[i - 1, j]
            upleft = D[i - 1, j - 1] if j > 0 else np.inf
            if upleft < min(left, up):
                i, j = i - 1, j - 1
            elif up < left:
                i, j = i - 1, j
            else:
                i, j = i, j - 1
        cells.append((i, j))
    return cells[::-1]


def _hirschberg(qs, ws, spec, i0, j0, out):
    """Append the pinned-corner path cells of (qs × ws) to ``out`` in
    LOCAL coordinates offset by the caller (see ``warping_path``)."""
    R, C = len(qs), len(ws)
    if R <= 2 or R * C <= _BASE_CELLS:
        out.extend((i0 + i, j0 + j)
                   for i, j in _small_path(qs, ws, spec, i0, j0))
        return
    mu = (R - 1) // 2                      # last row of the upper half
    F = _pinned_lastrow(qs[:mu + 1], ws, spec, i0, j0, flipped=False)
    Grev = _pinned_lastrow(qs[mu + 1:][::-1], ws[::-1], spec,
                           i0 + mu + 1, j0, flipped=True)
    G = Grev[::-1]     # G[j] = best cost (mu+1, j) -> (R-1, C-1)
    # the path crosses rows mu -> mu+1 with an up (j' = j) or a diagonal
    # (j' = j + 1) step; pick the cheapest crossing deterministically
    tot_up = F + G
    tot_diag = np.full(C, np.inf)
    tot_diag[:-1] = F[:-1] + G[1:]
    j_up = int(np.argmin(tot_up))
    j_dg = int(np.argmin(tot_diag))
    # strict < : on an exact tie the up-crossing wins (the start3 order —
    # upleft/diagonal only wins strict comparisons)
    if tot_diag[j_dg] < tot_up[j_up]:
        j, j_next = j_dg, j_dg + 1
    else:
        j, j_next = j_up, j_up
    _hirschberg(qs[:mu + 1], ws[:j + 1], spec, i0, j0, out)
    lower = []
    _hirschberg(qs[mu + 1:], ws[j_next:], spec, i0 + mu + 1, j0 + j_next,
                lower)
    out.extend(lower)


def host_f64(x) -> np.ndarray:
    """A numpy float64 copy of a tensor (any device) or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.float64)


def _normalized_f64(x, device) -> np.ndarray:
    """Z-normalize along the last axis in float32 on ``device`` (K2 on
    the card), then lift to float64 on the host for the sweeps."""
    return host_f64(normalize_batch(as_f32(x, device)))


def warping_path(query, reference, *, spec: DPSpec | None = None,
                 normalize: bool = True,
                 window: tuple[int, int] | None = None,
                 backend: str | None = None,
                 segment_width: int = 8,
                 device=None) -> np.ndarray:
    """The full optimal warping path of one query.

    Returns an (P, 2) int64 array of (query row, reference column)
    pairs in GLOBAL reference coordinates: first row ``(0, start)``,
    last row ``(M-1, end)``, unit steps only.

    ``window=(start, end)`` skips the window sweep (e.g. when the
    endpoints already came from a batched window request); otherwise
    one window sweep runs through ``backend`` (None = first
    window-capable) on ``device`` (the card unless ``device="cpu"``).
    Hard-min specs only — soft-min paths are distributions, see
    ``repro_torch.align.soft``.
    """
    spec = DEFAULT_SPEC if spec is None else spec
    if spec.soft:
        raise ValueError("warping_path needs a hard-min spec "
                         "(see repro_torch.align.soft)")
    if normalize or window is None:
        device = resolve_device(device)
    if normalize:
        q = _normalized_f64(query, device)
        r = _normalized_f64(reference, device)
    else:
        q, r = host_f64(query), host_f64(reference)
    if window is None:
        from repro_torch.core.api import sdtw
        res = sdtw(q[None, :], r, outputs=("cost", "start", "end"),
                   normalize=False, backend=backend, spec=spec,
                   segment_width=segment_width, device=device)
        window = (int(res.start[0]), int(res.end[0]))
    start, end = int(window[0]), int(window[1])
    if not 0 <= start <= end < len(r):
        raise ValueError(f"bad window {window} for reference of "
                         f"length {len(r)}")
    out: list[tuple[int, int]] = []
    # the window's top-left is global column ``start``: band masks are
    # global, and the cells come back in global columns.  (``repro``
    # passes column 0 here, so under a band its masks slide with the
    # window, and a window that starts right of column 0 can lose every
    # in-band path: an IndexError in the base case, or a path outside
    # the band.)
    _hirschberg(q, r[start:end + 1], spec, 0, start, out)
    return np.asarray(out, dtype=np.int64)


def warping_paths(queries, reference, *, spec: DPSpec | None = None,
                  normalize: bool = True,
                  backend: str | None = None,
                  segment_width: int = 8,
                  device=None) -> list[np.ndarray]:
    """Batch convenience: ONE batched window sweep (any window-capable
    backend, on ``device``), then per-query linear-memory tracebacks on
    the host."""
    from repro_torch.core.api import sdtw
    device = resolve_device(device)
    if normalize:
        queries = _normalized_f64(queries, device)
        reference = _normalized_f64(reference, device)
    else:
        queries, reference = host_f64(queries), host_f64(reference)
    res = sdtw(queries, reference, outputs=("cost", "start", "end"),
               normalize=False, backend=backend, spec=spec,
               segment_width=segment_width, device=device)
    return [warping_path(q, reference, spec=spec, normalize=False,
                         window=(int(s), int(e)))
            for q, s, e in zip(queries, res.start.tolist(),
                               res.end.tolist())]
