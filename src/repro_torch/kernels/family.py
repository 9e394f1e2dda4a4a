"""The recurrence-family wavefront K7 (``csrc/family_wavefront.cu``), its
plain PyTorch version, its launch counter and its operands' shaped
errors (the plan's are ``wavefront.check_plan``'s).

Replaces ``repro/kernels/wavefront.py::wavefront_call`` under the
family plans: ``KernelPlan.cell`` through ``DPSpec.family_cell``
(``:670-681``), the extra operands (``:95-99``, ``:797-831``) and the
folds ``CornerFold`` (twed, erp; ``:304``), ``LocalCellsFold`` (local,
``:341``) and ``SoftCellsFold`` (soft local, ``:389``).

The geometry is the sdtw wavefront's (:mod:`repro_torch.kernels.
wavefront`) over the zero-padded reference layout, ``32 * w`` columns a
chunk: both builds (hard-min and soft-min, one kernel template) run one
CTA of ``warps`` warps per query, each chunk's boundary column passed to
the next warp through a shared-memory ring (:func:`family_geometry`).
The family operands come from
:func:`repro_torch.kernels.ops.family_extras`: twed ``(r_prev,)`` and
erp ``(bt, bl)``, ``r_prev``/``bt`` zero-padded to the layout's length
and ``bl`` (B, M); local takes none.  Pad columns (``j >= n``) are
computed and never folded: the corner is column ``n - 1``, and the local
folds skip them (a zero pad column can score better than real ones).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import engine
from repro_torch.core.spec import DPSpec
from repro_torch.kernels import build, wavefront
from repro_torch.kernels.wavefront import RingGeometry

FAMILY_CODES = {"twed": 0, "erp": 1, "local": 2}
EXTRA_INPUTS = {"twed": ("r_prev",), "erp": ("bt", "bl"), "local": ()}
counter = build.LaunchCounter("family_wavefront")


def variant(spec: DPSpec) -> str:
    """The fold a launch runs: K7-corner (twed, erp), K7-cells (local),
    and their soft-min forms."""
    fold = "corner" if spec.recurrence.fold == "corner" else "cells"
    return f"K7-soft-{fold}" if spec.soft else f"K7-{fold}"


def refuse_grad(spec: DPSpec, *tensors) -> None:
    """K7 has no backward kernel: a soft family whose operands need a
    gradient raises instead of returning a cost with no graph."""
    if spec.family != "sdtw" and spec.soft and torch.is_grad_enabled() \
            and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"family {spec.family!r} under soft-min has no backward "
            "kernel on the kernel backend: use backend='engine', whose "
            "autograd covers the families")


def library_name(soft: bool) -> str:
    """The build of family_wavefront.cu of a reduction, hard-min or
    soft-min (the soft build's C entries carry the same ``soft_``
    prefix)."""
    return "soft_family_wavefront" if soft else "family_wavefront"


def family_geometry(m: int, family_: str,
                    warps: int = wavefront.WARPS) -> RingGeometry:
    """Size K7's launch, either reduction (``smem_bytes`` in
    family_wavefront.cu): the multi-warp rings of
    :func:`wavefront.ring_geometry`, one f32 a row, the same for every
    family and the same as K5/K6's.  Raises when it and the static fold
    arrays are over the shared memory a block can have (m above 26,912 at
    8 warps)."""
    geo = wavefront.ring_geometry(m, warps, "K7")
    if geo.smem_bytes + wavefront.STATIC_SMEM > wavefront.SMEM_LIMIT:
        raise ValueError(
            f"query length m={m} needs "
            f"{geo.smem_bytes + wavefront.STATIC_SMEM} bytes of shared "
            f"memory per block for {family_} (K7), over the "
            f"{wavefront.SMEM_LIMIT} a block can have")
    return geo


def validate(q: torch.Tensor, r_layout: torch.Tensor, extras: tuple, *,
             n: int, w: int, spec: DPSpec) -> None:
    """Shaped errors for plans and operands K7 does not take."""
    wavefront.check_plan(spec, kernel="family")
    wavefront.validate(q, r_layout, n=n, w=w, spec=spec)
    names = EXTRA_INPUTS[spec.family]
    if len(extras) != len(names):
        raise ValueError(
            f"family {spec.family!r} takes extra operands {names} (got "
            f"{len(extras)}): build them with ops.family_extras")
    for name, x in zip(names, extras):
        want = tuple(q.shape) if name == "bl" else tuple(r_layout.shape)
        if tuple(x.shape) != want or x.dtype != torch.float32 \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError(
                f"family operand {name!r} {x.dtype} {tuple(x.shape)} on "
                f"{x.device}: want a contiguous float32 tensor of shape "
                f"{want} on {q.device}, from ops.family_extras")


def visited_chunks(m: int, r_layout: torch.Tensor, w: int,
                   spec: DPSpec) -> int:
    """Band-skip: the chunks holding a column <= (m - 1) + band.  A
    global family's corner column n - 1 lies among them whenever the
    band does not block it (``n - 1 <= m - 1 + band``)."""
    return wavefront.band_grid_chunks(
        m, spec.band, r_layout.shape[0] // wavefront.chunk_cols(w), w)


def family_plain(q: torch.Tensor, r_layout: torch.Tensor, extras: tuple, *,
                 n: int, w: int, spec: DPSpec):
    """The plain version: the engine's family sweep over the same visited
    columns of the same layout, with the same extra operands, folding
    ``j < n`` only.  On the card, with no gradient asked for, the sweep's
    steady diagonals replay from a CUDA graph (``engine._dp_engine``'s
    ``_graph``); the bits are the eager sweep's."""
    cols = visited_chunks(q.shape[1], r_layout, w, spec) \
        * wavefront.chunk_cols(w)
    ex = tuple(x if name == "bl" else x[:cols] for name, x in
               zip(EXTRA_INPUTS[spec.family], extras))
    needs_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, r_layout, *ex))
    return engine._dp_engine(q.to(torch.float32),
                             r_layout[:cols].to(torch.float32), spec=spec,
                             return_window=False, n_valid=n, extras=ex,
                             _graph=q.is_cuda and not needs_grad)


def _fn(lib: ctypes.CDLL, soft: bool, op: str):
    """A C entry of a K7 build: ``launch`` or ``occupancy``."""
    fn = getattr(lib, f"{'soft_' if soft else ''}family_wavefront_{op}")
    fn.restype = ctypes.c_int
    if op == "launch":
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p] * 3)
    else:
        fn.argtypes = [ctypes.c_int] * 7
    return fn


def family_occupancy(m: int, w: int, family_: str,
                     warps: int = wavefront.WARPS, *, soft: bool) -> int:
    """CTAs of the (unbanded, sqeuclidean) K7 instantiation of either
    build resident per SM at this geometry
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; card only)."""
    geo = family_geometry(m, family_, warps)
    lib = build.library(library_name(soft))
    blocks = _fn(lib, soft, "occupancy")(
        m, w, FAMILY_CODES[family_], 0, 0, geo.warps, geo.slots)
    if blocks < 0:
        build.check(lib, -blocks, f"K7 occupancy (w={w}, m={m})")
    return blocks


def family_cuda(q: torch.Tensor, r_layout: torch.Tensor, extras: tuple, *,
                n: int, w: int, spec: DPSpec, warps: int = wavefront.WARPS,
                lib: ctypes.CDLL | None = None):
    """Launch K7, one CTA of ``warps`` warps per query, from the build
    of the spec's reduction.  ``lib``: another build of the same source
    and reduction (default: :func:`library_name`)."""
    B, m = q.shape
    chunks = visited_chunks(m, r_layout, w, spec)
    named = dict(zip(EXTRA_INPUTS[spec.family], extras))
    rx = named.get("r_prev", named.get("bt"))
    bl = named.get("bl")
    cost = torch.empty((B,), dtype=torch.float32, device=q.device)
    end = torch.empty((B,), dtype=torch.int32, device=q.device)
    band = -1 if spec.band is None else int(spec.band)
    # the constants are formed in double and rounded once to float32 by
    # ctypes, as the plain version's Python scalars are by torch
    consts = (spec.nu + spec.lam, 2.0 * spec.nu, spec.gap, spec.gap_penalty,
              spec.match_reward)
    ptrs = (q.data_ptr(), r_layout.data_ptr(),
            0 if rx is None else rx.data_ptr(),
            0 if bl is None else bl.data_ptr())
    shape = (B, m, n, chunks, band, w, FAMILY_CODES[spec.family],
             int(spec.distance == "abs"))
    geo = family_geometry(m, spec.family, warps)
    lib = lib if lib is not None else build.library(library_name(spec.soft))
    fn = _fn(lib, spec.soft, "launch")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(*ptrs, *shape, geo.warps, geo.slots, *consts, spec.gamma,
                    cost.data_ptr(), end.data_ptr(), stream)
    build.check(lib, status, f"family wavefront launch (w={w}, B={B}, "
                             f"m={m}, warps={geo.warps}, "
                             f"{spec.describe()})")
    counter.add(variant(spec))
    return cost, end


def family_wavefront(q: torch.Tensor, r_layout: torch.Tensor,
                     extras: tuple = (), *, n: int, w: int, spec: DPSpec):
    """The K7 wrapper.  q: (B, M) float32; r_layout from
    ``wavefront.prepare_reference``; extras from ``ops.family_extras``;
    n: the true reference length.  Returns (cost (B,), end (B,) int32):
    the corner (end n - 1, or (+inf, 0) when blocked) or the local
    fold's best cell and its column."""
    validate(q, r_layout, extras, n=n, w=w, spec=spec)
    if build.on_card(q):
        return family_cuda(q, r_layout, extras, n=n, w=w, spec=spec)
    return family_plain(q, r_layout, extras, n=n, w=w, spec=spec)
