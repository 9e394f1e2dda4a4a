"""K2: the batch z-normalizer kernels (``csrc/normalizer.cu``: a
one-warp-per-row kernel and a thread-block-cluster kernel for long
rows), their geometry, their plain PyTorch version, their launch counter
(by kernel), and their autograd wrapper.

Replaces ``repro/kernels/normalizer.py::normalizer_pallas``.  A tensor
on the CPU takes the plain version; a CUDA tensor launches the kernel or
raises.  Under autograd (grad enabled, an input that requires grad) the
forward is the same kernel, which also writes each row's mean and
variance, and the backward is the analytic z-norm gradient in plain
torch: the JAX package has no normalizer backward kernel either (it
differentiates the plain-jnp ``repro.core.normalize``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

EPS = 1e-12
ROW_MAX = 2048            # longest row the one-warp-per-row kernel takes
ROWS_PER_CTA = 4          # kRowsPerCta in normalizer.cu
CLUSTER_THREADS = 1024    # kClusterThreads
MAX_CLUSTER = 8           # CTAs per row, the portable cluster size limit
CLUSTER_VECS = (1, 2, 4, 8)
counter = build.LaunchCounter("normalizer")


class Geometry(NamedTuple):
    """Launch geometry of K2 for (rows, n)."""
    cluster: int      # 0: row kernel; else CTAs per row (a cluster)
    vec: int          # float4s a lane (row) / a thread (cluster); 0: loop
    threads: int      # per CTA
    grid: int         # CTAs


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def geometry(rows: int, n: int) -> Geometry:
    """K2's kernel and sizes (``normalizer_launch`` in normalizer.cu).

    Rows of up to ROW_MAX samples: one warp per row, ROWS_PER_CTA rows a
    CTA, ``vec`` float4s a lane (a power of two, 128 samples a float4
    across the warp).  Longer rows: a cluster of ``cluster`` CTAs of
    CLUSTER_THREADS per row, the fewest (a power of two, at most
    MAX_CLUSTER) that hold the row at 4 float4s a thread, then the fewest
    float4s a thread that hold it (vec 8 for rows past 8 x 1,024 x 16
    samples, and 0, a loop that reads the slice twice, past 8 x 1,024 x
    32)."""
    if rows < 1 or n < 1:
        raise ValueError(f"empty input of shape ({rows}, {n})")
    if n <= ROW_MAX:
        vec = _pow2_at_least(-(-n // (4 * 32)))
        return Geometry(0, vec, 32 * ROWS_PER_CTA,
                        -(-rows // ROWS_PER_CTA))
    per_cta = 4 * 4 * CLUSTER_THREADS
    cluster = min(MAX_CLUSTER, _pow2_at_least(-(-n // per_cta)))
    vec = _pow2_at_least(-(-n // (cluster * 4 * CLUSTER_THREADS)))
    if vec > max(CLUSTER_VECS):
        vec = 0
    return Geometry(cluster, vec, CLUSTER_THREADS, rows * cluster)


def normalize_plain(x: torch.Tensor, *, eps: float = EPS,
                    with_stats: bool = False):
    """Z-normalize each row of (rows, n) float32 ``x``: biased variance
    ``E[x^2] - E[x]^2`` and ``std = sqrt(max(var, eps))``, as
    ``repro.core.normalize.normalize_batch``.  ``with_stats`` also
    returns the (rows, 2) (mean, var)."""
    n = x.shape[-1]
    s = torch.sum(x, dim=-1, keepdim=True) / n
    sq = torch.sum(x * x, dim=-1, keepdim=True) / n - s * s
    std = torch.sqrt(torch.clamp(sq, min=eps))
    y = (x - s) / std
    if with_stats:
        return y, torch.cat([s, sq], dim=-1)
    return y


def normalize_cuda(x: torch.Tensor, *, eps: float = EPS,
                   with_stats: bool = False):
    """Launch the K2 kernel on (rows, n) float32 ``x`` (:func:`geometry`
    picks the row or the cluster kernel)."""
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(
            f"the normalizer kernel takes a contiguous (rows, n) float32 "
            f"tensor, got {x.dtype} of shape {tuple(x.shape)}")
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"empty input of shape {tuple(x.shape)}")
    geo = geometry(x.shape[0], x.shape[1])
    lib = build.library("normalizer")
    fn = lib.normalizer_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    y = torch.empty_like(x)
    stats = (torch.empty((x.shape[0], 2), dtype=torch.float32,
                         device=x.device) if with_stats else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(x.data_ptr(), y.data_ptr(),
                    0 if stats is None else stats.data_ptr(),
                    x.shape[0], x.shape[1], eps, geo.cluster, geo.vec,
                    stream)
    build.check(lib, status, f"normalizer launch ({tuple(x.shape)}, {geo})")
    counter.add("cluster" if geo.cluster else "rows")
    return (y, stats) if with_stats else y


class _ZNorm(torch.autograd.Function):
    """K2 forward, analytic backward.  With ``y = (x - mean) / std`` and
    ``std = sqrt(max(var, eps))``::

        dx = (g - mean(g) - y * mean(g * y)) / std

    where the clamp does not hold; where it does (``var <= eps``), std
    is a constant and the ``y * mean(g * y)`` term drops out."""

    @staticmethod
    def forward(ctx, x, eps):
        run = normalize_cuda if build.on_card(x) else normalize_plain
        y, stats = run(x, eps=eps, with_stats=True)
        ctx.save_for_backward(y, stats)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, g):
        y, stats = ctx.saved_tensors
        var = stats[:, 1:]
        std = torch.sqrt(torch.clamp(var, min=ctx.eps))
        gy = torch.where(var > ctx.eps, (g * y).mean(-1, keepdim=True), 0.0)
        return (g - g.mean(-1, keepdim=True) - y * gy) / std, None


def normalize(x: torch.Tensor, *, eps: float = EPS) -> torch.Tensor:
    """The wrapper: kernel for a CUDA tensor, plain version for a CPU
    tensor (only because it lies on the CPU); differentiable through
    :class:`_ZNorm` when autograd needs it."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ZNorm.apply(x, eps)
    if build.on_card(x):
        return normalize_cuda(x, eps=eps)
    return normalize_plain(x, eps=eps)
