"""``repro_torch.tune`` — measured plan autotuning with a persistent
cache.

Counterpart of ``repro.tune``.  ``segment_width="auto"`` on
:class:`repro_torch.Aligner` / :func:`repro_torch.sdtw` routes here:
:func:`autotune` measures the engine baseline plus a budgeted
hill-climb over kernel segment widths for the workload's (machine and
device, DPSpec, M, N, batch-bucket, outputs) key, then persists the
winner in a schema-versioned JSON cache so later processes dispatch
tuned plans with zero re-measurement.  Width only changes the sweep
schedule — hard-min results are bit-identical across every candidate,
soft-min ones equal to within 1e-6 (``tests/test_torch_tune.py``).
"""

from repro_torch.tune.cache import (TUNE_SCHEMA, TuningCache,
                                    default_cache, default_cache_path,
                                    machine_key, set_default_cache,
                                    workload_key)
from repro_torch.tune.tuner import (TuneBudget, TuneResult, autotune,
                                    batch_bucket, cached_verdict)

__all__ = [
    "TUNE_SCHEMA",
    "TuneBudget",
    "TuneResult",
    "TuningCache",
    "autotune",
    "batch_bucket",
    "cached_verdict",
    "default_cache",
    "default_cache_path",
    "machine_key",
    "set_default_cache",
    "workload_key",
]
