"""The public wrappers of the port's kernels: segment-width policy, the
reference layouts (forward, and reverse for the soft-DTW backward), the
static blocked-band answer and the clamp of indices to the true
reference.

Counterpart of ``repro.kernels.ops``.  The contract is ported, not the
TPU layout: no (8, 128) packing, no swizzle, no ``PAD_VALUE`` columns;
the wavefront takes a zero-padded 1-D reference and guards ``j < n``
(the reverse sweep masks its padding instead).  Soft-min specs run K5,
the recurrence families (twed / erp / local) K7 with their extra
operands from :func:`family_extras`, and ``compute_dtype=bfloat16``
bf16-K1.
"""

from __future__ import annotations

import torch

from repro_torch.core.spec import (DEFAULT_SPEC, NO_WINDOW, DPSpec,
                                   previous_samples)
from repro_torch.kernels import family, wavefront

DEFAULT_SEGMENT_WIDTH = 8
#   The untuned reference cells per lane (the paper's thread-coarsening
#   knob w, Fig. 3).
DEFAULT_WIDTH_CANDIDATES = wavefront.WIDTHS
#   (2, 4, 8, 14, 16, 32): the paper's sweep points, each a kernel
#   instantiation.


def ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def validate_segment_width(w) -> int:
    """A positive int (bools rejected) that the kernel is built for."""
    if isinstance(w, bool) or not isinstance(w, int):
        raise ValueError(
            f"segment_width must be an int >= 1 (or the string 'auto' "
            f"where autotuning is supported), got {w!r}")
    if w < 1:
        raise ValueError(f"segment_width must be >= 1, got {w}")
    if w not in DEFAULT_WIDTH_CANDIDATES:
        raise ValueError(
            f"segment_width={w} has no wavefront kernel instantiation; "
            f"choose one of {DEFAULT_WIDTH_CANDIDATES}")
    return w


def width_candidates(n: int, candidates=None) -> tuple:
    """Validated, sorted, deduplicated widths for a reference of length
    ``n``; widths whose padded layout is more than 4x the reference are
    dropped, and the smallest candidate always survives."""
    if n < 1:
        raise ValueError(f"reference length must be >= 1, got {n}")
    cands = sorted({validate_segment_width(w) for w in
                    (DEFAULT_WIDTH_CANDIDATES if candidates is None
                     else candidates)})
    if not cands:
        raise ValueError("empty segment-width candidate set")
    kept = [w for w in cands if ceil_to(n, wavefront.chunk_cols(w)) <= 4 * n]
    return tuple(kept) if kept else (cands[0],)


def prepare_reference(reference: torch.Tensor,
                      segment_width: int) -> torch.Tensor:
    """The kernel's reference layout for one width."""
    return wavefront.prepare_reference(
        reference, validate_segment_width(segment_width))


def prepare_reference_reverse(reference: torch.Tensor,
                              segment_width: int) -> torch.Tensor:
    """The reverse sweep's layout for one width (the counterpart of
    ``repro.kernels.ops.swizzle_reference_reverse``): the flipped
    reference, left-padded so that reverse chunk ``R-1-c`` covers the
    columns of forward chunk ``c``."""
    return wavefront.prepare_reference_reverse(
        reference, validate_segment_width(segment_width))


def band_blocked(m: int, n: int, band: int | None,
                 family_: str = "sdtw") -> bool:
    """True when the band leaves no fold-eligible cell: for sdtw, row
    m-1 has no column within ``band`` of it inside [0, n); for twed and
    erp, the corner (m-1, n-1) is out of reach (``band < |m - n|``); a
    local alignment is never blocked (cell (0, 0) is always in band)."""
    if band is None or family_ == "local":
        return False
    if family_ in ("twed", "erp"):
        return band < abs(m - n)
    return m - 1 - band > n - 1


def family_extras_ref(spec: DPSpec, reference: torch.Tensor, *,
                      segment_width: int) -> tuple:
    """The reference-derived family operands, zero-padded like the
    reference layout: twed's shifted reference ``r[j-1]`` (``r[-1] =
    0``), erp's gap-cost prefix ``bt[j] = cumsum d(r_k, g)``; empty for
    sdtw and local.  An ``Aligner`` computes them once per width, next
    to its layout; the kernel and its plain version read the same
    tensors (a ``cumsum`` on the card may sum in another order than on
    the CPU)."""
    r = reference.to(torch.float32)
    if spec.family == "twed":
        x = previous_samples(r)
    elif spec.family == "erp":
        x = spec.gap_prefix(r)
    else:
        return ()
    return (prepare_reference(x, segment_width),)


def family_extras_query(spec: DPSpec, queries: torch.Tensor) -> tuple:
    """The query-derived family operands: erp's (B, M) gap-cost prefix
    ``bl[b, i] = cumsum d(q_k, g)``; empty otherwise."""
    if spec.family == "erp":
        return (spec.gap_prefix(queries.to(torch.float32)).contiguous(),)
    return ()


def family_extras(spec: DPSpec, queries: torch.Tensor,
                  reference: torch.Tensor, *, segment_width: int) -> tuple:
    """The family's extra kernel operands in K7's order (twed
    ``(r_prev,)``, erp ``(bt, bl)``, none for sdtw and local)."""
    return (family_extras_ref(spec, reference, segment_width=segment_width)
            + family_extras_query(spec, queries))


def sdtw_wavefront_prepped(queries: torch.Tensor, r_layout: torch.Tensor,
                           *, n: int, segment_width: int = 8,
                           spec: DPSpec | None = None,
                           return_window: bool = False,
                           extras: tuple = (),
                           compute_dtype=torch.float32):
    """Run the wavefront on a prepared reference layout.

    queries: (B, M) float32 on the layout's device; n: the true reference
    length; extras: a family's operands from :func:`family_extras`;
    compute_dtype: float32, or bfloat16 for a hard-min sdtw spec
    (bf16-K1).  Returns (costs (B,) f32, ends (B,) i32), or (costs,
    starts, ends), with indices clamped to ``n - 1`` (``NO_WINDOW``
    kept).  A band that blocks every fold-eligible cell is answered
    without a launch: +inf, end 0, ``NO_WINDOW`` start — the engine's
    answer.
    """
    sp = DEFAULT_SPEC if spec is None else spec
    w = validate_segment_width(segment_width)
    B, m = queries.shape
    wavefront.check_plan(sp, compute_dtype=compute_dtype,
                         with_window=return_window)
    if band_blocked(m, n, sp.band, sp.family):
        dev = queries.device
        costs = torch.full((B,), float("inf"), dtype=torch.float32,
                           device=dev)
        ends = torch.zeros((B,), dtype=torch.int32, device=dev)
        if return_window:
            return costs, torch.full((B,), NO_WINDOW, dtype=torch.int32,
                                     device=dev), ends
        return costs, ends
    if sp.family != "sdtw":
        costs, ends = family.family_wavefront(queries, r_layout,
                                              tuple(extras), n=n, w=w,
                                              spec=sp)
        return costs, torch.clamp(ends, max=n - 1)
    if sp.soft:
        costs, ends = wavefront.soft_wavefront(queries, r_layout, n=n, w=w,
                                               spec=sp)
        return costs, torch.clamp(ends, max=n - 1)
    out = wavefront.wavefront(queries, r_layout, n=n, w=w, spec=sp,
                              with_window=return_window,
                              compute_dtype=compute_dtype)
    if return_window:
        costs, starts, ends = out
        return (costs, torch.clamp(starts, NO_WINDOW, n - 1),
                torch.clamp(ends, max=n - 1))
    costs, ends = out
    return costs, torch.clamp(ends, max=n - 1)


def sdtw_wavefront(queries: torch.Tensor, reference: torch.Tensor, *,
                   segment_width: int = 8, spec: DPSpec | None = None,
                   return_window: bool = False,
                   compute_dtype=torch.float32):
    """One-shot wavefront: layout, family operands, dispatch.  queries
    (B, M), reference (N,), both on one device; ``compute_dtype``
    float32 or bfloat16 (hard-min sdtw only, as in ``repro``)."""
    sp = DEFAULT_SPEC if spec is None else spec
    q = queries.to(torch.float32).contiguous()
    layout = prepare_reference(reference, segment_width)
    return sdtw_wavefront_prepped(
        q, layout, n=reference.shape[0], segment_width=segment_width,
        spec=sp, return_window=return_window,
        extras=family_extras(sp, q, reference, segment_width=segment_width),
        compute_dtype=compute_dtype)

