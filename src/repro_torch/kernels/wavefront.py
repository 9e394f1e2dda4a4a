"""K1/K3/K4: the hard-min sDTW wavefront kernel (``csrc/wavefront.cu``),
its plan geometry, its plain PyTorch version and its launch counter.

Replaces ``repro/kernels/wavefront.py::wavefront_call`` under the
hard-min sdtw plans: cost + end (K1), + start (K3, ``with_window``),
under a Sakoe–Chiba band with band-skip (K4).

Geometry (the port's own, not the TPU's (8, 128) tiles): one warp per
query; lane l of chunk c owns the ``w`` reference columns
``(c * 32 + l) * w + k``.  The reference layout is the normalized
reference zero-padded to a whole number of chunks; columns past the true
length ``n`` are computed and never folded.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine import sdtw_engine
from repro_torch.core.spec import DPSpec
from repro_torch.kernels import build

WARP = 32
WIDTHS = (2, 4, 8, 14, 16, 32)     # the instantiations in wavefront.cu
SMEM_LIMIT = 232_448               # dynamic shared memory per block, H100
KERNEL_DISTANCES = ("sqeuclidean", "abs")
counter = build.LaunchCounter("wavefront")


def variant(spec: DPSpec, with_window: bool) -> str:
    """The JAX package's name for the plan a launch runs: K1 (cost,
    end), K3 (+ start), K4 (either under a band)."""
    if spec.band is not None:
        return "K4"
    return "K3" if with_window else "K1"


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


def strip_bytes(m: int, with_window: bool) -> int:
    """Shared memory of one warp: two strips of m f32 (+ two of i32)."""
    return (4 if with_window else 2) * 4 * m


def validate(q: torch.Tensor, r_layout: torch.Tensor, *, n: int, w: int,
             spec: DPSpec, with_window: bool) -> None:
    """Shaped errors for operands the kernel does not take."""
    if w not in WIDTHS:
        raise ValueError(
            f"segment_width={w} has no wavefront kernel instantiation; "
            f"choose one of {WIDTHS}")
    if spec.distance not in KERNEL_DISTANCES:
        raise ValueError(
            f"the wavefront kernel computes {KERNEL_DISTANCES}, not "
            f"{spec.distance!r}: use the engine or ref backend")
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
    if strip_bytes(q.shape[1], with_window) > SMEM_LIMIT:
        raise ValueError(
            f"query length m={q.shape[1]} needs "
            f"{strip_bytes(q.shape[1], with_window)} bytes of boundary "
            f"strip, over the {SMEM_LIMIT} a block can have")


def wavefront_plain(q: torch.Tensor, r_layout: torch.Tensor, *, n: int,
                    w: int, spec: DPSpec, with_window: bool = False):
    """The plain version: the engine's anti-diagonal sweep over the same
    visited columns of the same layout, folding j < n only."""
    chunks = band_grid_chunks(q.shape[1], spec.band,
                              r_layout.shape[0] // chunk_cols(w), w)
    return sdtw_engine(q, r_layout[:chunks * chunk_cols(w)], spec=spec,
                       return_window=with_window, n_valid=n)


def wavefront_cuda(q: torch.Tensor, r_layout: torch.Tensor, *, n: int,
                   w: int, spec: DPSpec, with_window: bool = False):
    """Launch the kernel: one warp per query."""
    B, m = q.shape
    chunks = band_grid_chunks(m, spec.band,
                              r_layout.shape[0] // chunk_cols(w), w)
    cost = torch.empty((B,), dtype=torch.float32, device=q.device)
    end = torch.empty((B,), dtype=torch.int32, device=q.device)
    start = torch.empty((B if with_window else 1,), dtype=torch.int32,
                        device=q.device)
    lib = build.library("wavefront")
    fn = lib.wavefront_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 4)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), r_layout.data_ptr(), B, m, n, chunks,
                    -1 if spec.band is None else int(spec.band), w,
                    int(with_window), int(spec.distance == "abs"),
                    cost.data_ptr(), end.data_ptr(), start.data_ptr(),
                    stream)
    build.check(lib, status, f"wavefront launch (w={w}, B={B}, m={m})")
    counter.add(variant(spec, with_window))
    if with_window:
        return cost, start, end
    return cost, end


def wavefront(q: torch.Tensor, r_layout: torch.Tensor, *, n: int, w: int,
              spec: DPSpec, with_window: bool = False):
    """The wrapper.  q: (B, M) float32; r_layout from
    :func:`prepare_reference`; n: the true reference length.  Returns
    (cost, end) or (cost, start, end); end and start are raw columns
    (``repro_torch.kernels.ops`` clamps them)."""
    validate(q, r_layout, n=n, w=w, spec=spec, with_window=with_window)
    if build.on_card(q):
        return wavefront_cuda(q, r_layout, n=n, w=w, spec=spec,
                              with_window=with_window)
    return wavefront_plain(q, r_layout, n=n, w=w, spec=spec,
                           with_window=with_window)
