"""K2: the batch z-normalizer kernel (``csrc/normalizer.cu``), its plain
PyTorch version, its launch counter, and its autograd wrapper.

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

import torch

from repro_torch.kernels import build

EPS = 1e-12
counter = build.LaunchCounter("normalizer")


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
    """Launch the K2 kernel: one CTA per row of (rows, n) float32 ``x``."""
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(
            f"the normalizer kernel takes a contiguous (rows, n) float32 "
            f"tensor, got {x.dtype} of shape {tuple(x.shape)}")
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"empty input of shape {tuple(x.shape)}")
    lib = build.library("normalizer")
    fn = lib.normalizer_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    y = torch.empty_like(x)
    stats = (torch.empty((x.shape[0], 2), dtype=torch.float32,
                         device=x.device) if with_stats else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(x.data_ptr(), y.data_ptr(),
                    0 if stats is None else stats.data_ptr(),
                    x.shape[0], x.shape[1], eps, stream)
    build.check(lib, status, "normalizer launch")
    counter.add()
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
