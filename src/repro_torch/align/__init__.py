"""repro_torch.align — matched windows, warping paths and soft
alignments.

Counterpart of ``repro.align``.  Every artifact here is an ``outputs``
name on ``repro_torch.sdtw`` / ``repro_torch.Aligner``, validated
through the registry's capabilities:

  * **windows** (``outputs=("cost", "start", "end")``) — start pointers
    carried through the same sweep (K3 / K4 on the card);
  * **paths** (``outputs=("path",)``; ``warping_path`` /
    ``warping_paths``) — the full alignment via Hirschberg
    divide-and-conquer over the matched window, O(M + N) memory, in
    numpy float64 on the host;
  * **soft alignments** (``outputs=("soft_alignment",)``;
    ``expected_alignment``) — the smoothed alignment of soft-min specs,
    by autograd through a cost-matrix sweep, or the fused K6 pair on
    the kernel backend; ``soft_costs`` is the front-door forward path.

``repro_torch.align.oracle`` holds the full-matrix numpy backtrack
ground truth the fast paths are tested against (shared tie-break).
"""

from repro_torch.align.oracle import oracle_path, oracle_window, sdtw_matrix
from repro_torch.align.soft import (cost_matrix, expected_alignment,
                                    row_position_distribution,
                                    sdtw_soft_from_costs, soft_costs)
from repro_torch.align.traceback import warping_path, warping_paths
from repro_torch.align.window import window_arrays

__all__ = [
    "window_arrays",
    "warping_path", "warping_paths",
    "expected_alignment", "row_position_distribution",
    "cost_matrix", "sdtw_soft_from_costs", "soft_costs",
    "oracle_window", "oracle_path", "sdtw_matrix",
]
