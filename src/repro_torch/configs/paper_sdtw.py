"""The paper's own workload config (Table 1 / Fig. 3).

Batch of 512 queries x 2,000 samples each, reference series of 100,000
samples.  The port keeps its own copy of ``repro.configs.paper_sdtw`` so
that it imports nothing of the JAX package.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class SDTWWorkload:
    batch: int = 512          # queries per batch (paper §6)
    query_len: int = 2_000    # samples per query
    ref_len: int = 100_000    # reference series length
    segment_width: int = 8    # the JAX package's default width


PAPER = SDTWWorkload()

# reduced workload for CPU-bound tests of the same code paths
SMALL = SDTWWorkload(batch=16, query_len=64, ref_len=1_024)

# the soft-DTW gradient at the JAX package's full soft-backward shape
# (benchmarks/soft_backward.py --full), gamma 0.5
SOFT_TRAIN = SDTWWorkload(batch=256, query_len=256, ref_len=8_192)
SOFT_TRAIN_GAMMA = 0.5
