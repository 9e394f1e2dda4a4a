"""repro_torch — the PyTorch/CUDA port of ``repro`` (batched subsequence
DTW), for NVIDIA Hopper.

    import repro_torch
    res = repro_torch.sdtw(queries, reference,
                           outputs=("cost", "start", "end"))
    aligner = repro_torch.Aligner(reference)
    res = aligner(queries)

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  The package imports torch and numpy, never jax, and
nothing of ``repro``.
"""

from repro_torch.core.api import sdtw
from repro_torch.core.result import SDTWResult
from repro_torch.core.session import Aligner
from repro_torch.core.spec import DPSpec

__all__ = ["sdtw", "Aligner", "SDTWResult", "DPSpec"]
