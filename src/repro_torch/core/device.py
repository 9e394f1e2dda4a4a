"""Where the port's entry points run: on the CUDA card unless the caller
asks for the CPU, and never on the CPU by falling back."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  With no card, only an explicit
    ``device="cpu"`` runs (the plain versions of the kernels)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card unless told otherwise, and "
            "torch.cuda.is_available() is False: pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """A float32, contiguous copy-or-view of ``x`` (numpy, list or
    tensor) on ``device``."""
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(x)
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    return x.to(device=device, dtype=torch.float32).contiguous()
