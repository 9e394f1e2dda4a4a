"""Where a measurement ran: the machine fingerprint.

Counterpart of ``repro.obs.bench.machine_fingerprint``; the rest of that
module (the ``BENCH_*.json`` report schema) has no counterpart yet.  A
torch process can run on the CPU and on a CUDA card, so the fingerprint
describes one device: the tuning cache keys its verdicts on it, and a
time measured on the card never answers a CPU call.
"""

from __future__ import annotations

import functools
import os
import platform

import torch


def fingerprint_device(device=None) -> torch.device:
    """The device a fingerprint describes: ``None`` is the current CUDA
    card when one is available, else the CPU; ``"cuda"`` without an
    index is the current card."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _fingerprint(dev: torch.device) -> tuple:
    out = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "cpu_count": os.cpu_count() or 1,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "device_type": dev.type,
    }
    try:
        if dev.type == "cuda":
            out["device_name"] = torch.cuda.get_device_name(dev)
            out["device_count"] = torch.cuda.device_count()
        else:
            out["device_name"] = platform.processor() or platform.machine()
            out["device_count"] = 1
    except Exception:                      # a fingerprint must never fail
        out["device_name"] = "unavailable"
        out["device_count"] = 0
    return tuple(out.items())


def machine_fingerprint(device=None) -> dict:
    """Platform, Python, CPU count, torch and its CUDA version, and the
    device's type, name and count (see :func:`fingerprint_device` for
    ``device=None``)."""
    return dict(_fingerprint(fingerprint_device(device)))
