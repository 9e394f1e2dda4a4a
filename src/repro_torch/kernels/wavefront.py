"""The sDTW wavefront kernels (``csrc/wavefront.cu``), their plan
geometry, their plain PyTorch versions and their launch counters.

Replace ``repro/kernels/wavefront.py::wavefront_call`` under the sdtw
plans:

* hard-min (``wavefront``): cost + end (K1), + start (K3,
  ``with_window``), under a Sakoe–Chiba band with band-skip (K4); with
  ``compute_dtype=torch.bfloat16`` the same sweeps with bf16 cells and
  carries and a float32 fold (bf16-K1, a third library built from the
  same source with ``-DREPRO_BF16``);
* soft-min (``soft_wavefront``, ``soft_checkpoint``): the soft forward
  (K5, ``SoftMinFold``), and the checkpointed forward and the reverse
  sweep of the soft-DTW backward (K6, ``checkpoint=True`` /
  ``reverse=True``).

Geometry (the port's own, not the TPU's (8, 128) tiles): lane l of
chunk c owns the ``w`` reference columns ``(c * 32 + l) * w + k``; both
kernels run one CTA of ``warps`` warps per query, warp p sweeping the
visited chunks p, p + warps, ... and passing each chunk's right boundary
column to the next warp through a shared-memory ring
(:func:`hard_geometry`, :func:`soft_ring_geometry`); :func:`longest_query`
is the longest query a plan can launch.  The reference layout is the
normalized reference zero-padded to a whole number of chunks; columns
past the true length ``n`` are computed and never folded.  A reverse
sweep reads the flipped reference left-padded to the same length
(:func:`prepare_reference_reverse`), so reverse chunk ``R-1-c`` covers
forward chunk ``c``; its pad columns (original ``j >= n``) are masked to
``SOFT_BIG``.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.engine import sdtw_engine
from repro_torch.core.spec import INF, SOFT_BIG, DPSpec
from repro_torch.kernels import build

WARP = 32
WIDTHS = (2, 4, 8, 14, 16, 32)     # the instantiations in wavefront.cu
SMEM_LIMIT = 232_448               # shared memory per block, H100
STATIC_SMEM = 128                  # a multi-warp kernel's static fold arrays
WARPS = 8                          # multi-warp kernels: warps per CTA (query)
MAX_WARPS = 8                      # kMaxWarps in the .cu sources
RING_GROUP = 32                    # ring rows per full/empty mbarrier pair
QUERY_PAD = 32                     # zeros each side of the staged query
KERNEL_DISTANCES = ("sqeuclidean", "abs")
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
counter = build.LaunchCounter("wavefront")
soft_counter = build.LaunchCounter("soft_wavefront")


def variant(spec: DPSpec, with_window: bool,
            compute_dtype=torch.float32) -> str:
    """The JAX package's name for the plan a launch runs: K1 (cost,
    end), K3 (+ start), K4 (either under a band); ``bf16-`` in front
    for the bf16 compute type."""
    name = "K4" if spec.band is not None else ("K3" if with_window
                                               else "K1")
    return name if compute_dtype == torch.float32 else f"bf16-{name}"


def chunk_cols(w: int) -> int:
    """Reference columns one warp sweeps per chunk."""
    return WARP * w


def num_chunks(n: int, w: int) -> int:
    return -(-n // chunk_cols(w))


def band_grid_chunks(m: int, band: int | None, chunks: int, w: int) -> int:
    """Chunks a banded sweep must visit: every cell with
    ``j > (m - 1) + band`` is out of band for every query row, so the
    trailing chunks made only of such columns are skipped (the port's
    counterpart of ``repro.kernels.wavefront.band_grid_blocks``)."""
    if band is None:
        return chunks
    return max(1, min(chunks, (m - 1 + band) // chunk_cols(w) + 1))


def prepare_reference(r: torch.Tensor, w: int) -> torch.Tensor:
    """(n,) -> (num_chunks * 32 * w,) float32, zero-padded: the layout
    the kernel reads (built once per width by an ``Aligner``)."""
    n = r.shape[0]
    pad = num_chunks(n, w) * chunk_cols(w) - n
    return torch.nn.functional.pad(r.to(torch.float32), (0, pad)) \
        .contiguous()


def prepare_reference_reverse(r: torch.Tensor, w: int) -> torch.Tensor:
    """(n,) -> (num_chunks * 32 * w,): ``flip(r)`` zero-padded on the
    LEFT to the forward layout's length, the reverse sweep's layout.
    Flipped column ``j'`` is original column ``n_pad - 1 - j'``."""
    n = r.shape[0]
    pad = num_chunks(n, w) * chunk_cols(w) - n
    return torch.nn.functional.pad(torch.flip(r.to(torch.float32), (0,)),
                                   (pad, 0)).contiguous()


def soft_geometry(m: int, n: int, n_pad: int, w: int, band: int | None,
                  reverse: bool) -> tuple[int, int, int, int]:
    """(chunk0, chunks, jlim, shift) of a soft sweep over a layout of
    ``n_pad`` columns.  Forward: chunks [0, visited), fold j < n.
    Reverse: the band leaves the same number of chunks alive, but the
    dead ones lead (original ``j > m - 1 + band`` is flipped ``j' <
    n_pad - m - band``), so the sweep starts ``chunk0`` chunks in;
    flipped columns ``j' < jlim = n_pad - n`` are padding, and the band
    test shifts by ``m - n_pad`` (original ``i - j = shift - (i' -
    j')``).  The port's counterpart of ``KernelPlan.block_offset`` and
    ``KernelPlan.band_shift``, in 32·w-column chunks."""
    total = n_pad // chunk_cols(w)
    visited = band_grid_chunks(m, band, total, w)
    if reverse:
        return total - visited, visited, n_pad - n, m - n_pad
    return 0, visited, n, 0


class RingGeometry(NamedTuple):
    """Launch geometry of a multi-warp wavefront (the hard-min kernel,
    K5/K6, K7) for one query length."""
    warps: int        # warps per CTA; one CTA per query
    slots: int        # ring groups of RING_GROUP rows, per link
    ring_rows: int    # slots * RING_GROUP
    smem_bytes: int   # dynamic shared memory per CTA


def ring_slots(m: int, warps: int, kernel: str) -> int:
    """Ring groups a link of a multi-warp kernel at query length m.

    Consecutive chunks start about ``(m + 31) / warps`` steps apart, so a
    link needs that many rows for no warp to wait, and the rings of the
    CTA together one column of m rows: with much less, every warp can
    end up waiting on a full ring (a deadlock).  Two groups a link are
    added as slack; ``tests/test_torch_wavefront_design.py`` runs the
    kernels' schedule on a model of the mbarriers and finds the smallest
    ring that completes two groups below this one at m = 2,000."""
    if not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"warps={warps}: {kernel} takes 1 to "
                         f"{MAX_WARPS} warps per CTA")
    return -(-(m + WARP - 1) // (RING_GROUP * warps)) + 2


def ring_geometry(m: int, warps: int, kernel: str,
                  lanes: int = 1) -> RingGeometry:
    """Size a multi-warp kernel's rings (:func:`ring_slots`).  Dynamic
    shared memory: the mbarriers (16 bytes a slot and link), the query
    padded by QUERY_PAD zeros on each side, and one ring per link of
    ``lanes`` 4-byte values a row."""
    slots = ring_slots(m, warps, kernel)
    ring_rows = slots * RING_GROUP
    smem = (16 * warps * slots + 4 * (m + 2 * QUERY_PAD)
            + 4 * lanes * warps * ring_rows)
    return RingGeometry(warps, slots, ring_rows, smem)


def hard_geometry(m: int, with_window: bool,
                  warps: int = WARPS) -> RingGeometry:
    """The hard-min kernel's launch (``smem_bytes`` in wavefront.cu): its
    rings carry f32, plus i32 with the start lane."""
    return ring_geometry(m, warps, "the hard-min kernel",
                         2 if with_window else 1)


def soft_ring_geometry(m: int, warps: int = WARPS) -> RingGeometry:
    """The soft kernel's launch, K5 and the K6 pair (``soft_smem_bytes``
    in wavefront.cu): one f32 a ring row, as K7's
    (``family.family_geometry``).  The ring counterpart of
    :func:`soft_geometry`, which gives the chunks a sweep visits."""
    return ring_geometry(m, warps, "the soft-min kernel")


def block_smem(m: int, spec: DPSpec, *, with_window: bool = False) -> int:
    """Shared memory per block (dynamic and the static fold arrays) of
    the kernel that runs ``spec``'s plan at query length m (WARPS warps
    a multi-warp CTA): the hard-min
    kernel's rings (:func:`hard_geometry`), or the soft kernel's
    (:func:`soft_ring_geometry`), which are K7's under either reduction
    (``family.family_geometry``)."""
    geo = (hard_geometry(m, with_window) if plan_kernel(spec) == "hard"
           else soft_ring_geometry(m))
    return geo.smem_bytes + STATIC_SMEM


def longest_query(spec: DPSpec, *, with_window: bool = False,
                  compute_dtype=torch.float32) -> int:
    """The longest query the kernel backend can launch for a plan: the
    spec, ``with_window`` (the ``start`` output, K3) and the compute
    type (bf16-K1 stages the same rings as K1, so it does not move the
    limit).  The largest m whose :func:`block_smem` fits the block's
    SMEM_LIMIT: 26,912 for K1/K4/bf16-K1, K5/K6 and K7, 18,145 for K3
    (at 8 warps)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype}")
    lo, hi = 0, SMEM_LIMIT          # every query row takes 4 bytes or more
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if block_smem(mid, spec, with_window=with_window) <= SMEM_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    return lo


def plan_kernel(spec: DPSpec) -> str:
    """The wrapper a spec runs: ``"family"`` (K7) for twed / erp /
    local, ``"soft"`` (K5/K6) for soft-min sdtw, ``"hard"`` (K1/K3/K4,
    bf16-K1) for the rest."""
    if spec.family != "sdtw":
        return "family"
    return "soft" if spec.soft else "hard"


def check_plan(spec: DPSpec, *, kernel: str | None = None,
               compute_dtype=torch.float32, with_window: bool = False,
               reverse: bool = False, checkpoint: bool = False) -> None:
    """Every plan rule in one place, the shaped errors of
    ``repro.kernels.wavefront.KernelPlan.__post_init__``: the kernels
    compute sqeuclidean and abs; a family runs in float32, has no start
    lane and no reverse or checkpoint sweep; soft-min has no argmin path
    and accumulates in float32; a reverse sweep is soft-min; a
    checkpoint carries no start lane.  ``kernel``: the wrapper asking
    (:func:`plan_kernel`), which must be the one the spec runs."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype}")
    if spec.distance not in KERNEL_DISTANCES:
        raise ValueError(
            f"the wavefront kernel computes {KERNEL_DISTANCES}, not "
            f"{spec.distance!r}: use the engine or ref backend")
    fam = spec.family
    if fam != "sdtw":
        if with_window:
            raise ValueError(
                f"family {fam!r} has no matched-window start pointers "
                "on the kernel backend (window outputs ride the sdtw "
                "free-start recurrence); use engine or ref for family "
                "window outputs")
        if reverse or checkpoint:
            raise ValueError(
                "reverse/checkpoint sweeps implement the soft-DTW "
                f"backward; family {fam!r} plans do not support them")
        if compute_dtype != torch.float32:
            raise ValueError(
                f"family {fam!r} runs the kernel in float32 (transition "
                "costs and boundary prefixes must match the engine grid "
                f"bit-for-bit); got compute_dtype={compute_dtype}")
    if spec.soft and with_window:
        raise ValueError("with_window needs a hard-min spec: soft-min has "
                         "no argmin path")
    if spec.soft and compute_dtype != torch.float32:
        raise ValueError(
            "the soft-min channel accumulates logsumexp pairs in float32; "
            f"got compute_dtype={compute_dtype}")
    if reverse and not spec.soft:
        raise ValueError("reverse sweeps exist for the soft-DTW backward; "
                         "hard-min plans have no reverse mode")
    if checkpoint and with_window:
        raise ValueError("checkpoint plans carry only the cost channel's "
                         "boundary strips; with_window is not supported")
    runs = plan_kernel(spec)
    if kernel is None or kernel == runs:
        return
    if runs == "family":
        raise ValueError(
            f"the sdtw wavefront kernels run family 'sdtw', not {fam!r}: "
            "family specs run K7 (repro_torch.kernels.family)")
    if kernel == "family":
        raise ValueError("K7 runs the families twed, erp and local, not "
                         "'sdtw': sdtw specs run the sdtw wavefront")
    if kernel == "soft":
        raise ValueError(f"the soft wavefront needs a softmin spec "
                         f"(reduction='softmin'), got {spec.describe()}")
    raise ValueError(f"the hard-min wavefront runs hard-min specs: "
                     f"{spec.describe()} runs the soft wavefront (K5)")


def validate(q: torch.Tensor, r_layout: torch.Tensor, *, n: int, w: int,
             spec: DPSpec, with_window: bool = False) -> None:
    """Shaped errors for operands the kernels do not take (the plan's
    own are :func:`check_plan`'s); the query length against the shared
    memory of the kernel that runs ``spec`` (:func:`block_smem`)."""
    if w not in WIDTHS:
        raise ValueError(
            f"segment_width={w} has no wavefront kernel instantiation; "
            f"choose one of {WIDTHS}")
    if q.ndim != 2 or q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError(
            f"queries must be a contiguous (B, M) float32 tensor, got "
            f"{q.dtype} of shape {tuple(q.shape)}")
    if q.shape[0] < 1 or q.shape[1] < 1:
        raise ValueError(f"empty query batch of shape {tuple(q.shape)}")
    cols = chunk_cols(w)
    if r_layout.ndim != 1 or r_layout.dtype != torch.float32 \
            or not r_layout.is_contiguous() or r_layout.shape[0] % cols:
        raise ValueError(
            f"reference layout {r_layout.dtype} {tuple(r_layout.shape)} "
            f"does not match segment_width={w}: expected a contiguous 1-D "
            f"float32 tensor whose length is a multiple of {cols}, from "
            f"prepare_reference(reference, {w})")
    if not 1 <= n <= r_layout.shape[0] or r_layout.shape[0] - n >= cols:
        raise ValueError(
            f"reference length n={n} does not fit the layout of "
            f"{r_layout.shape[0]} columns (segment_width={w}): re-build "
            f"it with prepare_reference(reference, {w})")
    if q.device != r_layout.device:
        raise ValueError(f"queries on {q.device}, reference layout on "
                         f"{r_layout.device}")
    m = q.shape[1]
    smem_bytes = block_smem(m, spec, with_window=with_window)
    if smem_bytes > SMEM_LIMIT:
        raise ValueError(
            f"query length m={m} needs {smem_bytes} bytes of shared memory "
            f"per block, over the {SMEM_LIMIT} a block can have (longest "
            f"query {longest_query(spec, with_window=with_window)}; "
            f"backend='engine' runs any length)")


def wavefront_plain(q: torch.Tensor, r_layout: torch.Tensor, *, n: int,
                    w: int, spec: DPSpec, with_window: bool = False,
                    compute_dtype=torch.float32):
    """The plain version: the engine's anti-diagonal sweep over the same
    visited columns of the same layout, folding j < n only (in bf16
    with a float32 fold for bf16-K1)."""
    chunks = band_grid_chunks(q.shape[1], spec.band,
                              r_layout.shape[0] // chunk_cols(w), w)
    return sdtw_engine(q, r_layout[:chunks * chunk_cols(w)], spec=spec,
                       return_window=with_window, n_valid=n,
                       compute_dtype=compute_dtype)


def _hard_fn(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    if name == "wavefront_launch":
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p] * 4)
    else:
        fn.argtypes = [ctypes.c_int] * 7
    return fn


def hard_library(compute_dtype=torch.float32) -> ctypes.CDLL:
    """The hard-min library of a compute type (bf16-K1's for bfloat16)."""
    return build.library("wavefront_bf16" if compute_dtype == torch.bfloat16
                         else "wavefront")


def hard_occupancy(m: int, w: int, *, with_window: bool = False,
                   warps: int = WARPS) -> int:
    """CTAs of the (float32, unbanded, sqeuclidean) hard-min kernel
    resident per SM at this geometry
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; card only)."""
    geo = hard_geometry(m, with_window, warps)
    lib = hard_library()
    blocks = _hard_fn(lib, "wavefront_occupancy")(
        m, w, int(with_window), 0, 0, geo.warps, geo.slots)
    if blocks < 0:
        build.check(lib, -blocks, f"wavefront occupancy (w={w}, m={m})")
    return blocks


def wavefront_cuda(q: torch.Tensor, r_layout: torch.Tensor, *, n: int,
                   w: int, spec: DPSpec, with_window: bool = False,
                   compute_dtype=torch.float32, warps: int = WARPS,
                   lib: ctypes.CDLL | None = None):
    """Launch the kernel: one CTA of ``warps`` warps per query.  The
    float32 operands are rounded to bf16 on load by the bf16 build.
    ``lib``: another build of the hard-min source (default: the
    library of ``compute_dtype``)."""
    B, m = q.shape
    chunks = band_grid_chunks(m, spec.band,
                              r_layout.shape[0] // chunk_cols(w), w)
    geo = hard_geometry(m, with_window, warps)
    cost = torch.empty((B,), dtype=torch.float32, device=q.device)
    end = torch.empty((B,), dtype=torch.int32, device=q.device)
    start = torch.empty((B if with_window else 1,), dtype=torch.int32,
                        device=q.device)
    lib = lib if lib is not None else hard_library(compute_dtype)
    fn = _hard_fn(lib, "wavefront_launch")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), r_layout.data_ptr(), B, m, n, chunks,
                    -1 if spec.band is None else int(spec.band), w,
                    int(with_window), int(spec.distance == "abs"),
                    geo.warps, geo.slots, cost.data_ptr(), end.data_ptr(),
                    start.data_ptr(), stream)
    build.check(lib, status, f"wavefront launch (w={w}, B={B}, m={m}, "
                             f"warps={geo.warps}, {compute_dtype})")
    counter.add(variant(spec, with_window, compute_dtype))
    if with_window:
        return cost, start, end
    return cost, end


def wavefront(q: torch.Tensor, r_layout: torch.Tensor, *, n: int, w: int,
              spec: DPSpec, with_window: bool = False,
              compute_dtype=torch.float32):
    """The wrapper.  q: (B, M) float32; r_layout from
    :func:`prepare_reference`; n: the true reference length;
    ``compute_dtype`` float32 (K1/K3/K4) or bfloat16 (bf16-K1, its
    float32 cost a bf16 value).  Returns (cost, end) or (cost, start,
    end); end and start are raw columns (``repro_torch.kernels.ops``
    clamps them)."""
    check_plan(spec, kernel="hard", compute_dtype=compute_dtype,
               with_window=with_window)
    validate(q, r_layout, n=n, w=w, spec=spec, with_window=with_window)
    if build.on_card(q):
        return wavefront_cuda(q, r_layout, n=n, w=w, spec=spec,
                              with_window=with_window,
                              compute_dtype=compute_dtype)
    return wavefront_plain(q, r_layout, n=n, w=w, spec=spec,
                           with_window=with_window,
                           compute_dtype=compute_dtype)


# ------------------------------------------------------------ soft-min
def soft_variant(reverse: bool, checkpoint: bool) -> str:
    """K5 (soft forward), K6-forward (+ checkpoint strips), K6-reverse."""
    if reverse:
        return "K6-reverse"
    return "K6-forward" if checkpoint else "K5"


def soft_tile(C: torch.Tensor, valid: torch.Tensor, left_col: torch.Tensor,
              *, spec: DPSpec, reverse: bool) -> torch.Tensor:
    """One chunk's soft DP tile from its left boundary column.

    C: (B, m, W) local costs; valid: (m, W) or (B, m, W) bool, False for
    masked cells (out of band; reverse padding); left_col: (B, m), the
    column at local j = -1 (a checkpoint strip; ``SOFT_BIG`` at the first
    chunk).  Returns the (B, m, W) tile.  A skewed anti-diagonal sweep of
    m + W - 1 steps, as ``repro.kernels.backward._tile``; ``reverse``
    swaps in the mirrored boundary rules of the reverse sweep (flipped
    row 0: no up, 0-weight termination in the upleft slot; flipped row
    m-1: no left).
    """
    B, m, W = C.shape
    big = spec.big
    dev = C.device
    ii = torch.arange(m, device=dev)
    jl = torch.arange(m + W - 1, device=dev)[None, :] - ii[:, None]
    skew = jl.clamp(0, W - 1).expand(B, m, -1)
    Cs = C.gather(2, skew)
    Vs = valid.expand(B, m, W).gather(2, skew) & (jl >= 0) & (jl < W)
    left_up = torch.cat([torch.full((B, 1), big, device=dev),
                         left_col[:, :-1]], dim=1)
    row0, last = ii == 0, ii == m - 1
    d1 = torch.full((B, m), big, device=dev)
    d2 = d1
    Ds = torch.empty_like(Cs)
    for t in range(m + W - 1):
        edge = jl[:, t] == 0            # local column 0 reads the boundary
        left = torch.where(edge, left_col, d1)
        up = torch.roll(d1, 1, -1)
        upleft = torch.where(edge, left_up, torch.roll(d2, 1, -1))
        if reverse:
            d0 = Cs[:, :, t] + spec.reduce3(
                torch.where(last, big, left), torch.where(row0, big, up),
                torch.where(row0, 0.0, upleft))
        else:
            d0 = spec.cell_update(Cs[:, :, t], left, up, upleft,
                                  free_start=row0)
        d0 = torch.where(Vs[:, :, t], d0, big)
        Ds[:, :, t] = d0
        d2, d1 = d1, d0
    unskew = (ii[:, None] + torch.arange(W, device=dev)[None, :])
    return Ds.gather(2, unskew.expand(B, m, W))


def tile_valid(m: int, cols: torch.Tensor, spec: DPSpec, *, jlim: int,
               shift: int, reverse: bool) -> torch.Tensor:
    """(m, len(cols)) mask of a tile's live cells in the sweep's own
    column coordinates ``cols``: in band, and for a reverse sweep not
    padding (``cols >= jlim``)."""
    ii = torch.arange(m, device=cols.device)[:, None]
    valid = ((cols >= jlim) if reverse else torch.ones_like(
        cols, dtype=torch.bool))[None, :].expand(m, -1)
    in_band = spec.band_valid(ii, cols[None, :] + shift)
    return valid if in_band is None else valid & in_band


def soft_readout(bottom: torch.Tensor, foldable: torch.Tensor,
                 spec: DPSpec):
    """Soft cost and hard end of a (B, cols) bottom row over the
    ``foldable`` columns: ``-gamma * logsumexp(-x / gamma)``, and +inf
    where no foldable cell is reachable (a blocked band)."""
    vals = torch.where(foldable, bottom, spec.big)
    end = torch.argmin(vals, dim=1)          # first minimum: earliest
    best = vals.gather(1, end[:, None])[:, 0]
    x = torch.where(foldable, -bottom / spec.gamma, -INF)
    cost = -spec.gamma * torch.logsumexp(x, dim=1)
    return torch.where(best >= SOFT_BIG / 2, INF, cost), end.to(torch.int32)


def checkpoint_plain(q: torch.Tensor, r_layout: torch.Tensor, *, n: int,
                     w: int, spec: DPSpec, reverse: bool = False):
    """The plain version of K6: the chunk loop of the kernel, each chunk
    a :func:`soft_tile` from the previous chunk's last column.  Returns
    (cost, end, strips (B, chunks, m)) as :func:`soft_checkpoint`."""
    B, m = q.shape
    W = chunk_cols(w)
    chunk0, chunks, jlim, shift = soft_geometry(
        m, n, r_layout.shape[0], w, spec.band, reverse)
    left = torch.full((B, m), spec.big, device=q.device)
    strips, bottoms = [], []
    for c in range(chunk0, chunk0 + chunks):
        cols = torch.arange(c * W, (c + 1) * W, device=q.device)
        C = spec.cell_cost(q[:, :, None], r_layout[cols][None, None, :])
        valid = tile_valid(m, cols, spec, jlim=jlim, shift=shift,
                           reverse=reverse)
        D = soft_tile(C, valid, left, spec=spec, reverse=reverse)
        strips.append(left)
        left = D[:, :, -1]
        bottoms.append(D[:, -1, :])
    cols = torch.arange(chunk0 * W, (chunk0 + chunks) * W, device=q.device)
    foldable = (cols >= jlim) if reverse else (cols < jlim)
    in_band = spec.band_valid(m - 1, cols + shift)
    if in_band is not None:
        foldable = foldable & in_band
    cost, end = soft_readout(torch.cat(bottoms, dim=1), foldable, spec)
    return cost, end + chunk0 * W, torch.stack(strips, dim=1)


def soft_plain(q: torch.Tensor, r_layout: torch.Tensor, *, n: int, w: int,
               spec: DPSpec):
    """The plain version of K5: the port's soft engine over the same
    visited columns of the same layout, folding j < n only."""
    chunks = band_grid_chunks(q.shape[1], spec.band,
                              r_layout.shape[0] // chunk_cols(w), w)
    return sdtw_engine(q, r_layout[:chunks * chunk_cols(w)], spec=spec,
                       n_valid=n)


def _soft_fn(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    if name == "soft_wavefront_launch":
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 4)
    else:
        fn.argtypes = [ctypes.c_int] * 7
    return fn


def soft_occupancy(m: int, w: int, *, reverse: bool = False,
                   warps: int = WARPS) -> int:
    """CTAs of the (unbanded, sqeuclidean) soft kernel resident per SM at
    this geometry (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``;
    card only)."""
    geo = soft_ring_geometry(m, warps)
    lib = build.library("soft_wavefront")
    blocks = _soft_fn(lib, "soft_wavefront_occupancy")(
        m, w, int(reverse), 0, 0, geo.warps, geo.slots)
    if blocks < 0:
        build.check(lib, -blocks, f"soft wavefront occupancy (w={w}, "
                                  f"m={m})")
    return blocks


def soft_cuda(q: torch.Tensor, r_layout: torch.Tensor, *, n: int, w: int,
              spec: DPSpec, reverse: bool = False,
              checkpoint: bool = False, warps: int = WARPS,
              lib: ctypes.CDLL | None = None):
    """Launch the soft kernel: one CTA of ``warps`` warps per query.
    Returns (cost, end), or (cost, end, strips) for a checkpoint or
    reverse sweep.  ``lib``: another build of the soft source (default:
    ``soft_wavefront``)."""
    B, m = q.shape
    chunk0, chunks, jlim, shift = soft_geometry(
        m, n, r_layout.shape[0], w, spec.band, reverse)
    geo = soft_ring_geometry(m, warps)
    strips = checkpoint or reverse
    cost = torch.empty((B,), dtype=torch.float32, device=q.device)
    end = torch.empty((B,), dtype=torch.int32, device=q.device)
    ckpt = (torch.empty((B, chunks, m), dtype=torch.float32,
                        device=q.device) if strips else None)
    lib = lib if lib is not None else build.library("soft_wavefront")
    fn = _soft_fn(lib, "soft_wavefront_launch")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), r_layout.data_ptr(), B, m, jlim, chunk0,
                    chunks, -1 if spec.band is None else int(spec.band),
                    shift, float(spec.gamma), w, int(reverse),
                    int(spec.distance == "abs"), geo.warps, geo.slots,
                    cost.data_ptr(), end.data_ptr(),
                    0 if ckpt is None else ckpt.data_ptr(), stream)
    build.check(lib, status, f"soft wavefront launch (w={w}, B={B}, m={m}, "
                             f"warps={geo.warps}, "
                             f"{soft_variant(reverse, checkpoint)})")
    soft_counter.add(soft_variant(reverse, checkpoint))
    return (cost, end, ckpt) if strips else (cost, end)


def soft_wavefront(q: torch.Tensor, r_layout: torch.Tensor, *, n: int,
                   w: int, spec: DPSpec):
    """The K5 wrapper: soft cost and hard end of each query (end a raw
    column; ``repro_torch.kernels.ops`` clamps it)."""
    check_plan(spec, kernel="soft")
    validate(q, r_layout, n=n, w=w, spec=spec)
    if build.on_card(q):
        return soft_cuda(q, r_layout, n=n, w=w, spec=spec)
    return soft_plain(q, r_layout, n=n, w=w, spec=spec)


def soft_checkpoint(q: torch.Tensor, r_layout: torch.Tensor, *, n: int,
                    w: int, spec: DPSpec, reverse: bool = False):
    """The K6 wrapper.  Forward (``reverse=False``): q (B, m) over
    :func:`prepare_reference`; returns (cost, end, strips), strips[:, c]
    the F column entering visited chunk c (``SOFT_BIG`` for c = 0).
    Reverse: flipped queries over :func:`prepare_reference_reverse`;
    returns the reverse cost readout (equal to the forward cost), the
    flipped argmin column, and the B strips of the visited flipped
    chunks, in flipped row order."""
    check_plan(spec, kernel="soft", reverse=reverse, checkpoint=True)
    validate(q, r_layout, n=n, w=w, spec=spec)
    if build.on_card(q):
        return soft_cuda(q, r_layout, n=n, w=w, spec=spec, reverse=reverse,
                         checkpoint=True)
    return checkpoint_plain(q, r_layout, n=n, w=w, spec=spec,
                            reverse=reverse)
