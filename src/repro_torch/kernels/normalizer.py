"""K2: the batch z-normalizer kernel (``csrc/normalizer.cu``), its plain
PyTorch version, and its launch counter.

Replaces ``repro/kernels/normalizer.py::normalizer_pallas``.  A tensor
on the CPU takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

EPS = 1e-12
counter = build.LaunchCounter("normalizer")


def normalize_plain(x: torch.Tensor, *, eps: float = EPS) -> torch.Tensor:
    """Z-normalize each row of (rows, n) float32 ``x``: biased variance
    ``E[x^2] - E[x]^2`` and ``std = sqrt(max(var, eps))``, as
    ``repro.core.normalize.normalize_batch``."""
    n = x.shape[-1]
    s = torch.sum(x, dim=-1, keepdim=True) / n
    sq = torch.sum(x * x, dim=-1, keepdim=True) / n - s * s
    std = torch.sqrt(torch.clamp(sq, min=eps))
    return (x - s) / std


def normalize_cuda(x: torch.Tensor, *, eps: float = EPS) -> torch.Tensor:
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
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                    eps, stream)
    build.check(lib, status, "normalizer launch")
    counter.add()
    return y


def normalize(x: torch.Tensor, *, eps: float = EPS) -> torch.Tensor:
    """The wrapper: kernel for a CUDA tensor, plain version for a CPU
    tensor (only because it lies on the CPU)."""
    if build.on_card(x):
        return normalize_cuda(x, eps=eps)
    return normalize_plain(x, eps=eps)
