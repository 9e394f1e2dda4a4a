"""Full-matrix numpy backtrack oracle for subsequence-DTW alignment.

Counterpart of ``repro.align.oracle``, in numpy float64 on the port's
own ``core/ref.py::_np_cost``.  The trusted-but-O(M·N)-memory baseline
the streaming implementations are validated against: materialize the
whole DP matrix, read the window off the bottom row, and walk
predecessor pointers back to row 0.

Tie-breaking is the contract that makes "matches exactly" testable: a
cell's predecessor is chosen with the SAME strict-comparison order as
``DPSpec.start3`` (and therefore as every backend's forward start
propagation) — ``left`` beats ``up`` beats ``upleft`` on exact ties,
mirroring the hard-min operand order ``min(min(left, up), upleft)``.
With a shared tie-break, the forward pointer chain and this backward
walk traverse the same cells, so backends and oracle agree on WHICH
optimal alignment they report, not merely on its cost.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.ref import _np_cost
from repro_torch.core.spec import DEFAULT_SPEC, NO_WINDOW, DPSpec


def sdtw_matrix(q: np.ndarray, r: np.ndarray,
                spec: DPSpec | None = None) -> np.ndarray:
    """The full (M, N) hard-min sDTW matrix in float64 (0-indexed; row 0
    is the free-start row ``D[0, j] = cost(q[0], r[j])``)."""
    spec = DEFAULT_SPEC if spec is None else spec
    if spec.soft:
        raise ValueError("sdtw_matrix is hard-min only "
                         "(see repro_torch.align.soft for soft-min)")
    q = np.asarray(q, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    m, n = len(q), len(r)
    D = np.full((m, n), np.inf)
    for i in range(m):
        for j in range(n):
            if spec.band is not None and abs(i - j) > spec.band:
                continue
            c = _np_cost(spec, q[i], r[j])
            if i == 0:
                D[i, j] = c          # free start: D[-1, j] == 0
            else:
                left = D[i, j - 1] if j > 0 else np.inf
                upleft = D[i - 1, j - 1] if j > 0 else np.inf
                D[i, j] = c + min(left, D[i - 1, j], upleft)
    return D


def _backstep(D: np.ndarray, i: int, j: int) -> tuple[int, int]:
    """The predecessor of cell (i, j) under the shared tie-break."""
    left = D[i, j - 1] if j > 0 else np.inf
    up = D[i - 1, j]
    upleft = D[i - 1, j - 1] if j > 0 else np.inf
    # start3's comparison order: upleft wins only on STRICT <, up wins
    # over left only on STRICT <
    if upleft < min(left, up):
        return i - 1, j - 1
    if up < left:
        return i - 1, j
    return i, j - 1


def oracle_path(q: np.ndarray, r: np.ndarray,
                spec: DPSpec | None = None,
                end: int | None = None) -> np.ndarray:
    """The optimal warping path as an (P, 2) int array of (query row,
    reference column) pairs, first row ``(0, start)``, last row
    ``(M-1, end)``.  ``end`` overrides the bottom-row argmin (used to
    extract the path of a k-th best window)."""
    spec = DEFAULT_SPEC if spec is None else spec
    D = sdtw_matrix(q, r, spec)
    m = D.shape[0]
    if end is None:
        end = int(np.argmin(D[m - 1]))
    i, j = m - 1, int(end)
    cells = [(i, j)]
    while i > 0:
        i, j = _backstep(D, i, j)
        cells.append((i, j))
    return np.asarray(cells[::-1], dtype=np.int64)


def oracle_window(q: np.ndarray, r: np.ndarray,
                  spec: DPSpec | None = None) -> tuple[float, int, int]:
    """(cost, start, end) of the best matched window — the full-matrix
    ground truth for every backend's window sweep."""
    spec = DEFAULT_SPEC if spec is None else spec
    D = sdtw_matrix(q, r, spec)
    m = D.shape[0]
    end = int(np.argmin(D[m - 1]))
    cost = float(D[m - 1, end])
    if not np.isfinite(cost):        # no in-band alignment at all
        return cost, NO_WINDOW, end
    path = oracle_path(q, r, spec, end=end)
    return cost, int(path[0, 1]), end
