"""The soft-min sDTW training objective.

Counterpart of ``repro.train.step.make_sdtw_loss`` only; the rest of that
module is LM training (ROADMAP slice 10).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.backends import registry
from repro_torch.core.api import sdtw
from repro_torch.core.device import as_f32, resolve_device
from repro_torch.core.spec import resolve_spec


def make_sdtw_loss(reference, *, spec=None, gamma: float = 1.0,
                   band: int | None = None, backend: str | None = None,
                   segment_width: int = 8, normalize: bool = True,
                   reduce: str = "mean", device=None) -> Callable:
    """-> loss(pred (B, M)): the batch's soft-min sDTW cost against one
    reference series, a training objective for ``torch.autograd``.

    The spec is promoted to soft-min (``gamma``) if it is not already.
    ``backend=None`` takes, at each call, the device's first capable
    backend for the predictions' length (every registered backend is
    differentiable under soft-min): on the card the kernel backend, or
    the engine past the kernel's longest query; the kernel differentiates
    through the fused reverse-sweep backward (K6 and the tile pass)
    and, with ``normalize=True``, through the normalizer's backward; a
    reference tensor that requires grad receives its gradient too.
    ``reduce``: "mean" | "sum" | "none".
    """
    if reduce not in ("mean", "sum", "none"):
        raise ValueError(f"reduce must be 'mean', 'sum' or 'none', "
                         f"got {reduce!r}")
    resolved = resolve_spec(spec, gamma=gamma, band=band)
    if not resolved.soft:
        resolved = resolve_spec(resolved, reduction="softmin")
    dev = resolve_device(device)
    if backend is None:
        registry.select(resolved, device=dev)   # raises if none can run it
    ref = reference if isinstance(reference, torch.Tensor) else \
        as_f32(reference, dev)

    def loss(pred):
        cost = sdtw(pred, ref, outputs=("cost",), normalize=normalize,
                    backend=backend, spec=resolved,
                    segment_width=segment_width, device=dev).cost
        if reduce == "mean":
            return cost.mean()
        if reduce == "sum":
            return cost.sum()
        return cost

    return loss
