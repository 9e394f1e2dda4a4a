#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py            # on the card: build, check, time
    python3 chip_smoke.py --cpu      # rehearsal on the CPU, small size,
                                     # plain versions, no verdict line

Phases, one JSON line each:
  1. the card (``nvidia-smi`` name and power limit) and the kernel build
     (``nvcc -Xptxas -v``: registers and spills per instantiation; every
     K5/K6 and K7 (hard and soft) instantiation must report, and none may
     spill);
  2. K2 (its row and cluster kernels) against its plain version on the
     PAPER query batch (512, 2000) and reference (100,000,), and at 1 and
     513 rows of 1, 31, 2,001, 100,000, 100,003 and 300,003 samples, each
     aligned and one float into its buffer: y and the (mean, var) stats within
     atol = rtol = 1e-5;
  3. K1/K3/K4 (wavefront kernel) against its plain version, bit for bit:
     batches 1, 9, 64; m = 33 and 2000; references of one and several
     chunks with ragged tails; every instantiated width; bands None, 0,
     64 and 900 (band-skip, and the blocked band answered with no
     launch); both distances — every one of the 48 instantiations runs
     on a multi-chunk reference; references of 1, P-1, P, P+1 and 2P+1
     chunks (P warps per CTA) at every width, m 1 and 33; plus the
     float64 oracle on a small input;
  4. the main path at full PAPER width: ``repro_torch.sdtw`` and an
     ``Aligner`` on 512 queries x 2,000 against 100,000, every planted
     window found, launch counts read from the wrappers, and the whole
     output held against the plain version bit for bit; then the banded
     path (``repro_torch.sdtw(..., band=900)``, K4) on the same data,
     its counts read on their own, bit for bit against the plain version;
  5. ``geometry`` (warps per CTA, ring rows, shared memory per CTA, CTAs
     resident per SM of K1, K3, K5/K6 and hard and soft K7 (twed, erp,
     local; K5/K6 and K7 with their registers) at PAPER; K2's kernel,
     cluster size and grid) and
     ``times``: CUDA events (warm) for K1 and K3 at PAPER, every
     width, and a warm ``Aligner`` call; device time from a CUDA graph
     of 20 launches for the small kernels (K4, K2 on the batch and on the
     reference, K2's plain version and its yardstick
     ``torch.nn.functional.layer_norm``), each beside its host-paced
     time; each kernel's bound;
  6. ``soft_parity``: K5 and both K6 sweeps against their plain versions
     on every width, gamma 0.01 / 0.1 / 1.0, bands None, 0, 64 and 900,
     B 1 and 9, both distances, on references of several chunks whose
     last chunk is partly padding (every one of the 48 soft
     instantiations runs on a multi-chunk sweep), and on references of
     1, P-1, P, P+1 and 2P+1 chunks (P warps per CTA) at widths 2 and 8:
     cost and strips within atol = rtol = 1e-4, ends equal, the reverse
     cost readout within 1e-5 of the forward cost, and a blocked band
     answered with no launch;
  7. ``soft_main_path``: ``repro_torch.sdtw`` and an ``Aligner`` under
     ``DPSpec(reduction="softmin")`` (gamma 1.0) at full PAPER width,
     launch counts (K2, K5), all 512 costs within 1e-4 of the plain
     version, every end a column whose plain bottom-row value is within
     1e-4 of the plain minimum (exact misses counted);
  8. ``train_path``: ``repro_torch.train.make_sdtw_loss`` at the soft
     backward's full shape (B 256, M 256, N 8,192, w 8, gamma 0.5,
     normalize, mean): gradients to the predictions and the reference
     against engine autograd on the card (atol = rtol = 1e-4, and each
     nonzero and within 1e-4 of it in relative norm), the fused
     pass's peak memory below B*M*N*4 bytes, 5 SGD steps (lr 0.1 * B)
     after which the loss has dropped, launch counts per step;
  9. ``soft_alignment``: E from the fused path against ``align.soft``
     (engine autograd) at B 4, M 64, N 2,048, atol = rtol = 1e-4, with
     each row's mass;
 10. ``soft_times``: K5, K6-forward and K6-reverse at PAPER, K6 and the
     tile pass at the training shape, plain versions, bounds, the
     one-warp K5/K6's times of record beside;
 11. ``family_parity``: K7 (twed, erp, local; hard and soft; both
     distances; every width) against its plain version on references of
     three chunks whose last chunk is partly padding, unbanded and
     banded: hard bit for bit, soft within atol = rtol = 1e-4, ends
     equal; a blocked corner answered with no launch; hard and soft twed,
     erp and local on references of 1, P-1, P, P+1 and 2P+1 chunks (P
     warps per CTA) at widths 2 and 8, m 1, 33 and 200;
 12. ``family_main_path``: each family x reduction at full PAPER width
     through ``repro_torch.sdtw`` and an ``Aligner``, launch counts read
     on their own, costs finite, corner ends n - 1, planted local ends
     counted, each held to K7's plain version at PAPER's M and N (hard
     local on all 512 queries, the other five on every 8th; the plain
     sweep's steady diagonals replayed from a CUDA graph);
 13. ``family_times``: K7 at PAPER per family and reduction, bounds,
     the one-warp K7's times of record beside;
 14. ``bf16``: bf16-K1 against its plain version bit for bit (every
     width, band, distance, with and without the start lane; and at
     PAPER through ``ops.sdtw_wavefront(compute_dtype=bfloat16)``), the
     JAX bar at the JAX test's shape, ends at PAPER against float32;
 15. ``path``: warping paths of 16 PAPER queries (every 32nd, planted
     windows) through ``repro_torch.sdtw(outputs=("cost", "start",
     "end", "path"))`` and an ``Aligner``, K3 launches counted; each path
     runs from K3's start to its end in unit steps, sums (float64) to
     K3's cost within 2e-3 and covers the planted window; two equal the
     float64 full-matrix oracle; the host traceback's seconds a query;
 16. ``tune``: ``segment_width="auto"`` with ``REPRO_TORCH_TUNE_CACHE``
     on a temporary file — cold kernel tunes of K1 and K3 at PAPER (ms
     per width, winner, trials, seconds; each result bit-equal to w
     8's), a fresh cache over the file answering both with 0 trials and
     1 hit, a warm auto ``Aligner`` call beside a warm w 8 call, the
     unpinned kernel-against-engine tune at B 64, M 256, N 8,192 with
     ``registry.select`` counting its verdict, and soft (K5, within
     1e-6) and twed (K7, bit-equal) auto calls there against w 8;
 17. the ``kernels`` line.
The last line is the verdict ``{"ok": true, "device": {...}}``, printed
only when every phase passed on the card.  Any failure raises and exits
non-zero.  With no card (and no ``--cpu``) the script exits 1 at once.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM memory rate (NVIDIA data sheet, at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
# The wavefront is built without fused multiply-adds, so its operations
# issue at one per FP32 lane per clock: SMs x lanes x the card's maximum
# SM clock (the data sheet's 67 TFLOP/s counts an FMA as two and is out
# of these operations' reach).
FP32_LANES = 132 * 128
K1_OPS_PER_CELL = 5      # sub, mul (or abs), min, min, add
K3_OPS_PER_CELL = 8      # + the start pointer's two compares and select
K2_OPS_PER_ELEMENT = 4   # sum, sum of squares, subtract, multiply
BAND = 900               # the banded path's Sakoe-Chiba half-width
# A soft cell in min-shifted form: one of the three exponent arguments is
# (mn - mn) / gamma = 0, so the function needs two exponentials and one
# logarithm.  FP32: sub, mul (cost); min, min; two (sub, mul) exponent
# arguments; two adds (1 + e1 + e2); a multiply by gamma, a sub and the
# final add: 13 operations.  Special-function units (MUFU, 16 lanes per
# SM per clock): the two exponentials and the logarithm as one lg2 each,
# 3 operations.  The logarithm is counted on MUFU because that is its
# cheapest form; CUDA's full-accuracy logf, which the kernel calls, is an
# FMA polynomial of more FP32 operations than the one MUFU op it saves.
SOFT_FP32_OPS_PER_CELL = 13
SOFT_MUFU_OPS_PER_CELL = 3
MUFU_LANES = 132 * 16
PAPER_GAMMA = 1.0        # the DPSpec default
TRAIN_STEPS = 5
# The recurrence families at the parameters of the JAX package's family
# benchmark (benchmarks/family_matrix.py:28-33), gamma 0.7 under soft-min.
FAMILY_PARAMS = {"twed": dict(nu=0.5, lam=0.75), "erp": dict(gap=0.25),
                 "local": dict(gap_penalty=0.6, match_reward=1.1)}
FAMILY_GAMMA = 0.7
# K7's plain version sweeps every diagonal of PAPER with a few dozen torch
# launches each, the steady ones replayed from a CUDA graph: hard local is
# held to it at the full batch, the other five requests on every
# PLAIN_QUERY_STRIDE-th query (64 of 512) at PAPER's M and N.
PLAIN_QUERY_STRIDE = 8
# Operations a cell that the family function needs, from DPSpec.family_cell
# and the fold, with the terms that depend on the row alone or on the
# column alone hoisted out of the cell (twed's t_left d(r_j, r_j-1) + nu +
# lam and t_up d(q_i, q_i-1) + nu + lam; erp's d(r_j, g) and d(q_i, g)).
# FP32: a distance is sub + mul (or abs); twed's t_diag 6 (a distance,
# two adds, the |i - j| conversion, a mul: its d(q_i-1, r_j-1) is the
# d(q_i, r_j) of cell (i-1, j-1), already computed); erp's 2; local's 3 (a
# distance and the reward); then 3 adds of predecessor and transition and
# the hard reduce3's 2 mins; local adds the floor's min and 2 fold
# compares.  Soft-min replaces the 2 mins by reduce3's 10 FP32 and 3 MUFU
# (see the K5 count above, less the cell's distance and add); local's
# soft floor takes 6 FP32 and 2 MUFU (one exponential, one logarithm),
# and its running logsumexp 3 FP32 and one exponential a cell beside the
# 2 compares of its hard twin.
FAMILY_OPS = {  # (variant, family) -> (FP32, MUFU) a cell
    ("K7-corner", "twed"): (11, 0), ("K7-corner", "erp"): (7, 0),
    ("K7-cells", "local"): (11, 0),
    ("K7-soft-corner", "twed"): (19, 3), ("K7-soft-corner", "erp"): (15, 3),
    ("K7-soft-cells", "local"): (27, 6)}
# K7 at PAPER at one warp per query, before K7 ran several warps per query
# (ms, the times of record in PERF.md, "NVIDIA H100 80GB HBM3, 700.00 W"),
# printed beside this run's times
K7_ONE_WARP_MS = {("twed", False): 160.28, ("erp", False): 140.16,
                  ("local", False): 324.49, ("twed", True): 759.83,
                  ("erp", True): 743.66, ("local", True): 1438.88}
# K5/K6 at one warp per query, before they ran several warps per query
# (ms, the times of record in PERF.md, "NVIDIA H100 80GB HBM3, 700.00 W"),
# printed beside this run's times
K56_ONE_WARP_MS = {"k5_ms": 871.83, "k6f_paper_ms": 872.33,
                   "k6r_paper_ms": 811.30, "k6f_train_ms": 10.381,
                   "k6r_train_ms": 9.574}
# The soft-min parity cases at 1, P-1, P, P+1 and 2P+1 visited chunks:
# (widths, gamma, band, distance); the plain K6 sweeps a chunk at a time,
# host-paced, so the wide widths are left to the gpu tests
SOFT_CHUNK_CASES = (((2, 8), 0.1, None, "sqeuclidean"),
                    ((2,), 1.0, 900, "abs"))
# bf16-K1: the function is K1's 5 operations (sub, mul, min, min, add) in
# bf16.  The H100 issues them packed, two bf16 elements per FP32 lane per
# clock (HADD2/HMUL2/HMNMX2.BF16: NVIDIA's H100 data gives its non-tensor
# bf16 rate as twice its float32 rate, 134 against 67 TFLOP/s).
BF16_OPS_PER_CELL = 5
BF16_PER_LANE = 2
# K2 at lengths that give the row kernel and the cluster kernel ragged,
# unaligned rows (each with 1 and 513 rows; 300,003: the cluster kernel
# that reads its slice twice)
K2_LENGTHS = (1, 31, 2001, 100_000, 100_003, 300_003)
# the path phase: every (batch / PATH_QUERIES)-th query at PAPER, the
# first PATH_ORACLE of them also against the float64 full-matrix oracle
PATH_QUERIES = 16
PATH_ORACLE = 2
# the unpinned kernel-against-engine tune (batch, query, reference): the
# engine trial replays the host-paced plain sweep, too slow at PAPER
TUNE_SMALL = (64, 256, 8192)
TUNE_SMALL_CPU = (8, 32, 1024)
# device time of a small kernel: a CUDA graph of this many launches,
# replayed GRAPH_REPLAYS times between two events
GRAPH_LAUNCHES = 20
GRAPH_REPLAYS = 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clocks_mhz() -> tuple[float, float]:
    """(current, maximum) SM clock in MHz, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    now, top = out.stdout.strip().splitlines()[0].split(",")
    return float(now), float(top)


def ptxas_summary(logs: dict) -> dict:
    """Registers and spill bytes per kernel instantiation, from nvcc's
    ``-Xptxas -v`` report."""
    import re
    summary = {}
    for name, text in logs.items():
        rows, current = [], None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = {"entry": m.group(1)}
                t = re.search(r"ILi(\d+)ELb(\d)ELb(\d)ELb(\d)E", m.group(1))
                f = re.search(r"family_kernelILi(\d+)ELi(\d)ELb(\d)ELb(\d)E",
                              m.group(1))
                if f:
                    current.update(w=int(f.group(1)),
                                   family=("twed", "erp",
                                           "local")[int(f.group(2))],
                                   band=bool(int(f.group(3))),
                                   abs=bool(int(f.group(4))))
                elif t:
                    second = "reverse" if "soft" in m.group(1) else "window"
                    current.update(w=int(t.group(1)),
                                   **{second: bool(int(t.group(2)))},
                                   band=bool(int(t.group(3))),
                                   abs=bool(int(t.group(4))))
                rows.append(current)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and current is not None:
                current["spill_stores"] = int(m.group(1))
                current["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and current is not None:
                current["registers"] = int(m.group(1))
        for row in rows:
            if "w" in row:
                del row["entry"]
        summary[name] = rows
    return summary


def band_cells(np, m: int, n: int, band: int) -> int:
    """Cells of an m x n matrix with ``|i - j| <= band``: the work a
    banded sweep needs, whatever it visits."""
    i = np.arange(m)
    return int((np.minimum(n - 1, i + band) - np.maximum(0, i - band)
                + 1).clip(min=0).sum())


def make_data(np, cfg, seed: int):
    """The PAPER workload made from a seed: a reference whose samples
    alternate in sign with magnitudes in [0.5, 1.5), and queries that are
    slices of it at planted starts plus uniform noise in [-0.05, 0.05).

    A stationary reference keeps each 2,000-sample slice's mean and
    standard deviation close to the whole reference's, so independently
    z-normalized queries still match their windows; neighbouring samples
    differ by at least 1, so the planted start and end are the unique
    optimum and can be checked exactly."""
    rng = np.random.default_rng(seed)
    n, m, b = cfg.ref_len, cfg.query_len, cfg.batch
    sign = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    ref = (sign * (0.5 + rng.random(n))).astype(np.float32)
    starts = rng.integers(0, n - m, size=b)
    queries = np.stack([ref[s:s + m] for s in starts])
    queries = (queries + rng.uniform(-0.05, 0.05, size=(b, m))) \
        .astype(np.float32)
    return queries, ref, starts


class Timer:
    """Warm device time per call from CUDA events (host clock on the
    CPU rehearsal, where it is no device number)."""

    def __init__(self, torch, cuda: bool):
        self.torch, self.cuda = torch, cuda

    def __call__(self, fn, reps: int, warmup: int = 1) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps


def graph_ms(torch, fn, cuda: bool) -> float | None:
    """Device time (ms) of one call of ``fn``: GRAPH_LAUNCHES calls
    captured in a CUDA graph, the graph replayed GRAPH_REPLAYS times
    between two CUDA events, so that no host work paces the launches.
    None on the CPU rehearsal."""
    if not cuda:
        return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (GRAPH_REPLAYS * GRAPH_LAUNCHES)


def least_time(c, n_bytes: float, fp32_ops: float, mufu_ops: float = 0.0,
               bf16_ops: float = 0.0):
    """Least time (ms) and what bounds it: bytes over the memory rate
    against FP32 operations over the lane issue rate, special-function
    operations over the MUFU rate and bf16 operations over the packed
    bf16 rate, all at the card's maximum SM clock."""
    if not c.cuda:
        return None, "operations"
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(fp32_ops / c.lane_ops_per_s,
                mufu_ops / (MUFU_LANES * c.clock_max * 1e6),
                bf16_ops / (BF16_PER_LANE * c.lane_ops_per_s)) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def soft_spec(gamma: float, band=None, distance: str = "sqeuclidean"):
    from repro_torch.core.spec import DPSpec
    return DPSpec(reduction="softmin", gamma=gamma, band=band,
                  distance=distance)


def soft_parity(c) -> None:
    """Phase 6: K5 and both K6 sweeps against their plain versions."""
    np, torch = c.np, c.torch
    from repro_torch.core.normalize import normalize_batch
    from repro_torch.kernels import ops, wavefront
    rng = np.random.default_rng(c.seed + 2)

    def series(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return normalize_batch(x.to(c.dev))

    # (B, m, gamma, band, distance): with the widths, every soft
    # instantiation (width x reverse x band x distance) runs on a sweep
    # of at least two chunks; band 900 is what makes the banded sweeps
    # of the wide widths multi-chunk (m - 1 + 900 >= 32 * w)
    cases = [(9, 33, 0.01, None, "sqeuclidean"), (1, 33, 0.1, 0, "abs"),
             (9, 200, 1.0, 64, "sqeuclidean"), (1, 200, 1.0, None, "abs"),
             (9, 200, 0.1, 900, "abs"), (1, 200, 0.01, 900, "sqeuclidean")]
    widths = wavefront.WIDTHS if c.cuda else (2, 4)
    P = wavefront.WARPS
    # (w, n, B, m, gamma, band, distance, visited chunks or None): three
    # chunks, the last part pad, at every width; then 1, P-1, P, P+1 and
    # 2P+1 chunks (idle warps, a ring that wraps, a band-skipped reverse
    # sweep that starts chunk0 chunks in)
    runs = [(w, 2 * wavefront.chunk_cols(w) + wavefront.chunk_cols(w) // 2
             + 3, *case, None) for w in widths for case in cases]
    for ws, gamma, band, distance in SOFT_CHUNK_CASES:
        for w in (ws if c.cuda else (2,)):
            W = wavefront.chunk_cols(w)
            runs += [(w, (k - 1) * W + W // 2 + 3, 2, 33, gamma, band,
                      distance, k)
                     for k in (1, P - 1, P, P + 1, 2 * P + 1)]
    checked = mismatches = chunk_cases = 0
    worst = {"cost": 0.0, "strips": 0.0, "reverse_vs_forward": 0.0}
    before = wavefront.soft_counter.count
    t0 = time.perf_counter()
    for w, n, B, m, gamma, band, distance, chunks in runs:
        spec = soft_spec(gamma, band, distance)
        q, r = series(B, m), series(n)
        lay = ops.prepare_reference(r, w)
        rlay = ops.prepare_reference_reverse(r, w)
        qf = torch.flip(q, (1,)).contiguous()
        got = {"K5": wavefront.soft_wavefront(q, lay, n=n, w=w,
                                              spec=spec),
               "K6-forward": wavefront.soft_checkpoint(
                   q, lay, n=n, w=w, spec=spec),
               "K6-reverse": wavefront.soft_checkpoint(
                   qf, rlay, n=n, w=w, spec=spec, reverse=True)}
        want = {"K5": wavefront.soft_plain(q, lay, n=n, w=w, spec=spec),
                "K6-forward": wavefront.checkpoint_plain(
                    q, lay, n=n, w=w, spec=spec),
                "K6-reverse": wavefront.checkpoint_plain(
                    qf, rlay, n=n, w=w, spec=spec, reverse=True)}
        c.sync()
        for name in got:
            a, b = got[name], want[name]
            ok = bool(torch.allclose(a[0], b[0], rtol=1e-4, atol=1e-4))
            worst["cost"] = max(worst["cost"],
                                float((a[0] - b[0]).abs().max()))
            if name != "K6-reverse":      # the reverse end is unused
                ok = ok and torch.equal(a[1], b[1])
            if name != "K5":
                ok = ok and bool(torch.allclose(a[2], b[2], rtol=1e-4,
                                                atol=1e-4))
                worst["strips"] = max(
                    worst["strips"], float((a[2] - b[2]).abs().max()))
            checked += 1
            chunk_cases += chunks is not None
            if not ok:
                mismatches += 1
                emit({"phase": "soft_mismatch", "kernel": name, "w": w,
                      "B": B, "m": m, "n": n, "chunks": chunks,
                      "gamma": gamma, "band": band, "distance": distance,
                      "got": [x.flatten()[:4].tolist() for x in a],
                      "want": [x.flatten()[:4].tolist() for x in b]})
        fwd, rev = got["K6-forward"][0], got["K6-reverse"][0]
        rel = float(((rev - fwd).abs() / fwd.abs().clamp(min=1.0)).max())
        worst["reverse_vs_forward"] = max(worst["reverse_vs_forward"],
                                          rel)
        if rel > 1e-5:
            mismatches += 1
            emit({"phase": "soft_reverse_readout_mismatch", "w": w,
                  "B": B, "m": m, "gamma": gamma, "band": band,
                  "relative": rel})
    launches = wavefront.soft_counter.count - before
    # a band that blocks every bottom-row cell: +inf, end 0, no launch
    spec = soft_spec(1.0, 0)
    q, r = series(3, 200), series(50)
    out = ops.sdtw_wavefront_prepped(q, ops.prepare_reference(r, 2), n=50,
                                     segment_width=2, spec=spec)
    c.sync()
    blocked_ok = (wavefront.soft_counter.count == before + launches
                  and bool(torch.isinf(out[0]).all())
                  and bool((out[1] == 0).all()))
    emit({"phase": "soft_parity", "rule": "cost and strips within "
          "atol=rtol=1e-4 of the plain version, ends equal, reverse "
          "readout within 1e-5 (relative) of the forward cost",
          "cases": checked, "chunk_count_cases": chunk_cases,
          "warps_per_cta": P, "seconds": time.perf_counter() - t0,
          "mismatches": mismatches,
          "launches": launches, "widths": list(widths),
          "worst": worst, "blocked_band_no_launch": blocked_ok})
    require(mismatches == 0, f"{mismatches} soft kernel cases differ from "
                             f"the plain version")
    require(blocked_ok, "blocked soft band launched or answered wrong")


def soft_main_path(c, queries_np, ref_np, planted) -> dict:
    """Phase 7: soft-min sDTW at PAPER through the front door."""
    torch = c.torch
    import repro_torch
    from repro_torch.core.engine import sdtw_engine
    from repro_torch.core.normalize import normalize_batch
    from repro_torch.kernels import normalizer, wavefront
    cfg = c.cfg
    w, m, n, B = cfg.segment_width, cfg.query_len, cfg.ref_len, cfg.batch
    spec = soft_spec(PAPER_GAMMA)
    for counter in (normalizer.counter, wavefront.counter,
                    wavefront.soft_counter):
        counter.reset()
    t0 = time.perf_counter()
    res = repro_torch.sdtw(queries_np, ref_np, spec=spec, segment_width=w,
                           device=c.dev, backend=c.backend)
    aligner = repro_torch.Aligner(ref_np, spec=spec, segment_width=w,
                                  device=c.dev, backend=c.backend)
    al = aligner(queries_np)
    c.sync()
    seconds = time.perf_counter() - t0
    launches = {"normalizer": normalizer.counter.count,
                "soft_wavefront": dict(wavefront.soft_counter.by_variant),
                "wavefront": dict(wavefront.counter.by_variant)}
    require(not c.cuda or launches == {"normalizer": 4, "wavefront": {},
                                       "soft_wavefront": {"K5": 2}},
            f"soft main path launches {launches}: want 4 normalizer and "
            f"K5 twice")
    for out in (res.cost, res.end, al.cost, al.end):
        require(tuple(out.shape) == (B,), f"output shape {out.shape}")
    require(bool(torch.isfinite(res.cost).all()), "non-finite soft cost")
    require(torch.equal(res.cost, al.cost) and torch.equal(res.end, al.end),
            "soft sdtw and Aligner disagree")
    qn = normalize_batch(torch.from_numpy(queries_np).to(c.dev))
    layout = aligner.layout()
    c.sync()
    t0 = time.perf_counter()
    p_cost, p_end, bottom = sdtw_engine(qn, layout, spec=spec, n_valid=n,
                                        return_bottom=True)
    c.sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((res.cost - p_cost).abs().max())
    require(bool(torch.allclose(res.cost, p_cost, rtol=1e-4, atol=1e-4)),
            f"K5 costs differ from the plain version (max abs {err})")
    # an end must name a column whose plain bottom value is within the
    # tolerance of the plain minimum
    at_end = bottom.gather(1, res.end.long()[:, None])[:, 0]
    low = bottom.min(dim=1).values
    near = at_end <= low + 1e-4 + 1e-4 * low.abs()
    require(bool(near.all()), f"{int((~near).sum())} K5 ends off the "
                              f"plain bottom-row minimum")
    planted_t = torch.from_numpy(planted).to(c.dev)
    info = {"phase": "soft_main_path", "gamma": PAPER_GAMMA,
            "workload": {"batch": B, "query_len": m, "ref_len": n,
                         "segment_width": w},
            "seconds": seconds, "backend": aligner.backend.name,
            "launches": launches, "max_abs_err": err,
            "plain_ms": plain_ms,
            "end_exact_misses": int((res.end != p_end).sum()),
            "end_at_planted": int((res.end.long()
                                   == planted_t + m - 1).sum())}
    t0 = time.perf_counter()
    aligner(queries_np)
    c.sync()
    info["aligner_warm_call_ms"] = (time.perf_counter() - t0) * 1e3
    emit(info)
    info.update(qn=qn, layout=layout, aligner=aligner, spec=spec)
    return info


def train_inputs(c):
    """Predictions and a random-walk reference at the training shape,
    from the seed."""
    from repro_torch.configs.paper_sdtw import SDTWWorkload, SOFT_TRAIN
    cfg = SOFT_TRAIN if c.cuda else SDTWWorkload(batch=8, query_len=32,
                                                  ref_len=600)
    rng = c.np.random.default_rng(c.seed + 3)
    pred = rng.normal(size=(cfg.batch, cfg.query_len)).astype(c.np.float32)
    ref = c.np.cumsum(rng.normal(size=cfg.ref_len)).astype(c.np.float32)
    return cfg, pred, ref


def train_path(c) -> dict:
    """Phase 8: make_sdtw_loss at the training shape: gradients against
    engine autograd, peak memory, 5 SGD steps."""
    torch = c.torch
    from repro_torch.configs.paper_sdtw import SOFT_TRAIN_GAMMA
    from repro_torch.kernels import normalizer, wavefront
    from repro_torch.train.step import make_sdtw_loss
    cfg, pred_np, ref_np = train_inputs(c)
    B, M, N, w = cfg.batch, cfg.query_len, cfg.ref_len, cfg.segment_width
    gamma = SOFT_TRAIN_GAMMA

    def leaves():
        return (torch.from_numpy(pred_np).to(c.dev).requires_grad_(),
                torch.from_numpy(ref_np).to(c.dev).requires_grad_())

    def grads(backend):
        pred, ref = leaves()
        loss_fn = make_sdtw_loss(ref, gamma=gamma, segment_width=w,
                                 device=c.dev, backend=backend)
        c.sync()
        t0 = time.perf_counter()
        loss = loss_fn(pred)
        loss.backward()
        c.sync()
        return loss.detach(), pred.grad, ref.grad, \
            (time.perf_counter() - t0) * 1e3

    cells_bytes = B * M * N * 4
    if c.cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    fused = grads(c.backend)
    peak = torch.cuda.max_memory_allocated() if c.cuda else None
    plain = grads("engine")
    errs = {"loss": float((fused[0] - plain[0]).abs()),
            "d_pred": float((fused[1] - plain[1]).abs().max()),
            "d_reference": float((fused[2] - plain[2]).abs().max())}
    close = all(bool(torch.allclose(a, b, rtol=1e-4, atol=1e-4))
                for a, b in zip(fused[:3], plain[:3]))
    require(close, f"fused gradients differ from engine autograd: {errs}")
    # the gradients' own size, so that the absolute tolerance above is
    # read against it: each must be nonzero and agree in relative norm
    scale = {k: float(b.abs().max())
             for k, b in (("d_pred", plain[1]), ("d_reference", plain[2]))}
    rel = {k: float(torch.linalg.vector_norm(a - b)
                    / torch.linalg.vector_norm(b))
           for k, a, b in (("d_pred", fused[1], plain[1]),
                           ("d_reference", fused[2], plain[2]))}
    require(all(v > 0 for v in scale.values())
            and all(v <= 1e-4 for v in rel.values()),
            f"fused gradients: max |engine grad| {scale}, relative-norm "
            f"error {rel} (want > 0 and <= 1e-4)")
    require(not c.cuda or peak < cells_bytes,
            f"fused loss+backward peaked at {peak} bytes, not below "
            f"B*M*N*4 = {cells_bytes}")
    # 5 SGD steps on the predictions, counted per step
    lr = 0.1 * B
    pred = torch.from_numpy(pred_np).to(c.dev).requires_grad_()
    loss_fn = make_sdtw_loss(torch.from_numpy(ref_np).to(c.dev),
                             gamma=gamma, segment_width=w, device=c.dev,
                             backend=c.backend)
    counters = (normalizer.counter, wavefront.soft_counter)
    losses, per_step = [], []
    total = {"normalizer": 0, "soft_wavefront": {}}
    c.sync()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        for counter in counters:
            counter.reset()
        loss = loss_fn(pred)
        loss.backward()
        with torch.no_grad():
            pred -= lr * pred.grad
        pred.grad = None
        losses.append(float(loss.detach()))
        step = {"normalizer": normalizer.counter.count,
                "soft_wavefront": dict(wavefront.soft_counter.by_variant)}
        per_step.append(step)
        total["normalizer"] += step["normalizer"]
        for k, v in step["soft_wavefront"].items():
            total["soft_wavefront"][k] = total["soft_wavefront"].get(k, 0) + v
    c.sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    with torch.no_grad():
        final = float(loss_fn(pred))
    want = {"normalizer": 2, "soft_wavefront": {"K6-forward": 1,
                                                "K6-reverse": 1}}
    require(not c.cuda or all(s == want for s in per_step),
            f"training step launches {per_step}: want {want} per step")
    require(final < losses[0], f"loss did not drop: {losses} -> {final}")
    info = {"phase": "train_path", "workload": {
                "batch": B, "query_len": M, "ref_len": N,
                "segment_width": w, "gamma": gamma},
            "loss": "make_sdtw_loss(normalize=True, reduce='mean')",
            "tolerance": "atol=rtol=1e-4 against engine autograd, and "
                         "||fused - engine|| / ||engine|| <= 1e-4 for "
                         "each gradient",
            "max_abs_err": errs, "max_abs_grad": scale,
            "rel_norm_err": rel, "fused_ms": fused[3],
            "engine_autograd_ms": plain[3],
            "peak_bytes": peak,
            "peak_bytes_over_baseline": None if peak is None
            else peak - base, "bmn_bytes": cells_bytes,
            "sgd_lr": lr, "losses": losses, "loss_after": final,
            "sgd_step_ms": step_ms, "launches_per_step": per_step,
            "launches": total}
    emit(info)
    return info


def soft_alignment_phase(c) -> None:
    """Phase 9: E through the fused path against align.soft."""
    np, torch = c.np, c.torch
    import repro_torch
    from repro_torch.align.soft import expected_alignment_from
    from repro_torch.core.normalize import normalize_batch
    from repro_torch.kernels import wavefront
    B, M, N = (4, 64, 2048) if c.cuda else (2, 16, 300)
    rng = np.random.default_rng(c.seed + 4)
    q = rng.normal(size=(B, M)).astype(np.float32)
    r = np.cumsum(rng.normal(size=N)).astype(np.float32)
    spec = soft_spec(0.5)
    wavefront.soft_counter.reset()
    res = repro_torch.sdtw(q, r, spec=spec, outputs=("cost",
                                                      "soft_alignment"),
                           backend="kernel", device=c.dev)
    c.sync()
    launches = dict(wavefront.soft_counter.by_variant)
    E = res.soft_alignment
    plain = expected_alignment_from(
        normalize_batch(torch.from_numpy(q).to(c.dev)),
        normalize_batch(torch.from_numpy(r).to(c.dev)), spec)
    err = float((E - plain).abs().max())
    mass = E.sum(dim=-1)
    require(tuple(E.shape) == (B, M, N), f"E shape {tuple(E.shape)}")
    require(bool(torch.allclose(E, plain, rtol=1e-4, atol=1e-4)),
            f"fused E differs from align.soft (max abs {err})")
    require(bool((mass >= 1 - 1e-3).all()), "an E row carries mass < 1")
    require(not c.cuda or launches == {"K6-forward": 1, "K6-reverse": 1},
            f"soft_alignment launches {launches}")
    emit({"phase": "soft_alignment", "shape": [B, M, N], "gamma": 0.5,
          "launches": launches, "max_abs_err": err,
          "tolerance": "atol=rtol=1e-4 against align.soft",
          "row_mass": mass.tolist()})


def soft_times(c, main_soft: dict, train: dict) -> dict:
    """Phase 10: K5 and K6 at PAPER, K6 and the tile pass at the
    training shape; plain versions and bounds."""
    torch = c.torch
    from repro_torch.configs.paper_sdtw import SOFT_TRAIN_GAMMA
    from repro_torch.core.normalize import normalize_batch
    from repro_torch.kernels import backward, ops, wavefront
    timer = c.timer
    cfg = c.cfg
    w, m, n, B = cfg.segment_width, cfg.query_len, cfg.ref_len, cfg.batch
    spec, qn, layout = main_soft["spec"], main_soft["qn"], main_soft["layout"]
    rlay = main_soft["aligner"].layout(reverse=True)
    qf = torch.flip(qn, (1,)).contiguous()
    reps = 2 if c.cuda else 1
    out = {
        "k5_ms": timer(lambda: wavefront.soft_wavefront(
            qn, layout, n=n, w=w, spec=spec), reps),
        "k6f_paper_ms": timer(lambda: wavefront.soft_checkpoint(
            qn, layout, n=n, w=w, spec=spec), reps),
        "k6r_paper_ms": timer(lambda: wavefront.soft_checkpoint(
            qf, rlay, n=n, w=w, spec=spec, reverse=True), reps)}
    chunks = layout.shape[0] // wavefront.chunk_cols(w)
    cells = B * m * n
    in_bytes = (B * m + n) * 4
    out["k5_bound_ms"], out["k5_bound_by"] = least_time(
        c, in_bytes + B * 8, SOFT_FP32_OPS_PER_CELL * cells,
        SOFT_MUFU_OPS_PER_CELL * cells)
    out["k6_paper_bound_ms"], _ = least_time(
        c, in_bytes + B * 8 + B * chunks * m * 4,
        SOFT_FP32_OPS_PER_CELL * cells, SOFT_MUFU_OPS_PER_CELL * cells)

    # the training shape: the K6 pair, its plain versions, the tile pass
    tcfg, pred_np, ref_np = train_inputs(c)
    tB, tm, tn, tw = tcfg.batch, tcfg.query_len, tcfg.ref_len, \
        tcfg.segment_width
    tspec = soft_spec(SOFT_TRAIN_GAMMA)
    tq = normalize_batch(torch.from_numpy(pred_np).to(c.dev))
    tr = normalize_batch(torch.from_numpy(ref_np).to(c.dev))
    tlay = ops.prepare_reference(tr, tw)
    trlay = ops.prepare_reference_reverse(tr, tw)
    tqf = torch.flip(tq, (1,)).contiguous()
    out["k6f_train_ms"] = timer(lambda: wavefront.soft_checkpoint(
        tq, tlay, n=tn, w=tw, spec=tspec), 5 if c.cuda else 1)
    out["k6r_train_ms"] = timer(lambda: wavefront.soft_checkpoint(
        tqf, trlay, n=tn, w=tw, spec=tspec, reverse=True),
        5 if c.cuda else 1)
    got_f = wavefront.soft_checkpoint(tq, tlay, n=tn, w=tw, spec=tspec)
    got_r = wavefront.soft_checkpoint(tqf, trlay, n=tn, w=tw, spec=tspec,
                                      reverse=True)
    plain = {}
    for name, fn in (("f", lambda: wavefront.checkpoint_plain(
                         tq, tlay, n=tn, w=tw, spec=tspec)),
                     ("r", lambda: wavefront.checkpoint_plain(
                         tqf, trlay, n=tn, w=tw, spec=tspec, reverse=True))):
        c.sync()
        t0 = time.perf_counter()
        plain[name] = fn()
        c.sync()
        out[f"k6{name}_plain_ms"] = (time.perf_counter() - t0) * 1e3
    for name, got in (("f", got_f), ("r", got_r)):
        want = plain[name]
        err = max(float((got[0] - want[0]).abs().max()),
                  float((got[2] - want[2]).abs().max()))
        out[f"k6{name}_max_abs_err"] = err
        require(bool(torch.allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
                     and torch.allclose(got[2], want[2], rtol=1e-4,
                                        atol=1e-4)),
                f"K6-{name} differs from its plain version at the "
                f"training shape ({err})")
    tchunks = tlay.shape[0] // wavefront.chunk_cols(tw)
    tcells = tB * tm * tn
    strip_bytes = tB * tchunks * tm * 4
    out["k6f_bound_ms"], out["k6_bound_by"] = least_time(
        c, (tB * tm + tn) * 4 + tB * 8 + strip_bytes,
        SOFT_FP32_OPS_PER_CELL * tcells, SOFT_MUFU_OPS_PER_CELL * tcells)
    out["k6r_bound_ms"] = out["k6f_bound_ms"]
    # the tile pass alone (plain torch), from the K6 pair's strips
    ct = torch.full((tB,), 1.0 / tB, device=c.dev)
    fold = lambda: backward.fold_grads(  # noqa: E731
        tq, tlay, tn, got_f[0], got_f[2], got_r[2], ct, spec=tspec,
        segment_width=tw)
    out["tile_pass_ms"] = timer(fold, 1, warmup=0)
    # its work: both tiles rebuild every cell (a soft cell each, the
    # local cost's sub and mul shared), and E and the folds take 8 FP32
    # operations and one more exponential a cell
    out["tile_pass_bound_ms"], _ = least_time(
        c, (tB * tm + tn) * 4 * 2 + 2 * strip_bytes,
        (2 * SOFT_FP32_OPS_PER_CELL - 2 + 8) * tcells,
        (2 * SOFT_MUFU_OPS_PER_CELL + 1) * tcells)
    emit({"phase": "soft_times", "clock": "cuda events" if c.cuda
          else "host clock (cpu rehearsal, not a device number)",
          "paper": {"batch": B, "query_len": m, "ref_len": n,
                    "segment_width": w, "gamma": PAPER_GAMMA},
          "train": {"batch": tB, "query_len": tm, "ref_len": tn,
                    "segment_width": tw, "gamma": SOFT_TRAIN_GAMMA},
          "k5_plain_ms": main_soft["plain_ms"],
          "sgd_step_ms": train["sgd_step_ms"], **out,
          "one_warp_ms": K56_ONE_WARP_MS,
          "one_warp": "K5/K6 at one warp per query, PERF.md's times of "
                      "record (NVIDIA H100 80GB HBM3, 700.00 W)",
          "cells_paper": cells, "cells_train": tcells,
          "bound_rule": "max(bytes / 3.35 TB/s, 13 FP32 ops a cell / "
                        "(132 x 128 lanes x max SM clock), 3 MUFU ops a "
                        "cell (2 exp + 1 log) / (132 x 16 x max SM "
                        "clock)); tile pass: 2 x 13 - 2 + 8 FP32 and "
                        "2 x 3 + 1 MUFU a cell"})
    return out


def family_spec(fam: str, soft: bool, band=None,
                distance: str = "sqeuclidean"):
    from repro_torch.core.spec import resolve_spec
    return resolve_spec(None, family=fam, band=band, distance=distance,
                        reduction="softmin" if soft else "hardmin",
                        gamma=FAMILY_GAMMA if soft else None,
                        **FAMILY_PARAMS[fam])


def family_parity(c) -> None:
    """K7, every instantiation, against its plain version."""
    t0 = time.perf_counter()
    np, torch = c.np, c.torch
    from repro_torch.core.normalize import normalize_batch
    from repro_torch.kernels import family, ops, wavefront
    rng = np.random.default_rng(c.seed + 5)

    def series(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return normalize_batch(x.to(c.dev))

    widths = wavefront.WIDTHS if c.cuda else (2, 4)
    W = wavefront.chunk_cols(max(widths))
    n = 2 * W + W // 2 + 3     # three chunks at the widest width, the
    #                            last part padding (at every width)
    checked = mismatches = blocked = 0
    worst = {"hard": 0.0, "soft": 0.0}
    before = dict(family.counter.by_variant)
    for fam in ("twed", "erp", "local"):
        # (B, m, band): unbanded, and a band that masks cells but keeps
        # the corner (twed, erp) or skips chunks (local)
        cases = [(9, 33, None),
                 (1, 200, 64 if fam == "local" else n - 200 + 37)]
        for soft in (False, True):
            for distance in ("sqeuclidean", "abs"):
                for B, m, band in cases:
                    spec = family_spec(fam, soft, band, distance)
                    q, r = series(B, m), series(n)
                    lay2 = ops.prepare_reference(r, 2)
                    want = family.family_plain(
                        q, lay2, ops.family_extras(spec, q, r,
                                                   segment_width=2),
                        n=n, w=2, spec=spec)
                    for w in widths:
                        got = family.family_wavefront(
                            q, ops.prepare_reference(r, w),
                            ops.family_extras(spec, q, r, segment_width=w),
                            n=n, w=w, spec=spec)
                        c.sync()
                        err = float((got[0] - want[0]).abs().max())
                        kind = "soft" if soft else "hard"
                        worst[kind] = max(worst[kind], err)
                        ok = torch.equal(got[1], want[1]) and (
                            bool(torch.allclose(got[0], want[0], rtol=1e-4,
                                                atol=1e-4)) if soft
                            else torch.equal(got[0], want[0]))
                        checked += 1
                        if not ok:
                            mismatches += 1
                            emit({"phase": "family_mismatch", "w": w,
                                  "spec": spec.describe(), "B": B, "m": m,
                                  "n": n,
                                  "got": [x.tolist()[:4] for x in got],
                                  "want": [x.tolist()[:4] for x in want]})
                if fam != "local":
                    # band < |m - n|: the corner is cut off, no launch
                    spec = family_spec(fam, soft, n - 33 - 1)
                    q, r = series(3, 33), series(n)
                    k = family.counter.count
                    out = ops.sdtw_wavefront(q, r, segment_width=2,
                                             spec=spec)
                    c.sync()
                    require(family.counter.count == k
                            and bool(torch.isinf(out[0]).all())
                            and bool((out[1] == 0).all()),
                            f"blocked {spec.describe()} launched or "
                            f"answered wrong")
                    blocked += 1
    # K7's CTA of P warps at 1, P-1, P, P+1 and 2P+1 chunks (idle warps, a
    # ring that wraps), m 1, 33 and 200, hard (bit-equal) and soft; one
    # plain version per reference
    P = wavefront.WARPS
    chunk_cases = {"hard": 0, "soft": 0}
    for fam, soft in itertools.product(("twed", "erp", "local"),
                                       (False, True)):
        spec = family_spec(fam, soft)
        kind = "soft" if soft else "hard"
        for w in ((2, 8) if c.cuda else (2,)):
            W = wavefront.chunk_cols(w)
            for m in (1, 33, 200):
                for k in (1, P - 1, P, P + 1, 2 * P + 1):
                    n_c = (k - 1) * W + W // 2 + 3
                    q, r = series(3, m), series(n_c)
                    lay = ops.prepare_reference(r, w)
                    ex = ops.family_extras(spec, q, r, segment_width=w)
                    want = family.family_plain(q, lay, ex, n=n_c, w=w,
                                               spec=spec)
                    got = family.family_wavefront(q, lay, ex, n=n_c, w=w,
                                                  spec=spec)
                    c.sync()
                    err = float((got[0] - want[0]).abs().max())
                    worst[kind] = max(worst[kind], err)
                    checked += 1
                    chunk_cases[kind] += 1
                    if not (torch.equal(got[1], want[1]) and (bool(
                            torch.allclose(got[0], want[0], rtol=1e-4,
                                           atol=1e-4)) if soft
                            else torch.equal(got[0], want[0]))):
                        mismatches += 1
                        emit({"phase": "family_mismatch", "w": w,
                              "spec": spec.describe(), "B": 3, "m": m,
                              "n": n_c, "chunks": k,
                              "got": [x.tolist() for x in got],
                              "want": [x.tolist() for x in want]})
    launches = {k: v - before.get(k, 0)
                for k, v in family.counter.by_variant.items()}
    # the plain version itself: its steady diagonals replayed from a CUDA
    # graph on the card (what every case above and family_main_path hold
    # K7 to) against the eager sweep, one case per family x reduction
    from repro_torch.core import engine
    graph_cases = graph_mismatches = 0
    for fam, soft in itertools.product(("twed", "erp", "local"),
                                       (False, True)):
        spec = family_spec(fam, soft)
        q, r = series(4, 40), series(700)
        lay = ops.prepare_reference(r, 2)
        ex = ops.family_extras(spec, q, r, segment_width=2)
        outs = [engine._dp_engine(q, lay, spec=spec, return_window=False,
                                  n_valid=700, extras=ex, _graph=graph)
                for graph in (False, True)]
        c.sync()
        graph_cases += 1
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            graph_mismatches += 1
            emit({"phase": "family_plain_graph_mismatch",
                  "spec": spec.describe(),
                  "eager": [x.tolist() for x in outs[0]],
                  "graph": [x.tolist() for x in outs[1]]})
    emit({"phase": "family_parity", "rule": "hard bit-equal to the plain "
          "version, soft within atol=rtol=1e-4, ends equal; the plain "
          "version's graph sweep bit-equal to its eager sweep",
          "n": n, "widths": list(widths), "cases": checked,
          "chunk_count_cases": chunk_cases, "warps_per_cta": P,
          "plain_graph_vs_eager_cases": graph_cases,
          "plain_graph_mismatches": graph_mismatches,
          "seconds": time.perf_counter() - t0,
          "mismatches": mismatches, "worst_abs_err": worst,
          "blocked_corner_cases_no_launch": blocked, "launches": launches})
    require(mismatches == 0, f"{mismatches} K7 cases differ from the "
                             f"plain version")
    require(graph_mismatches == 0, f"{graph_mismatches} plain K7 graph "
                                   f"sweeps differ from the eager sweep")


def family_main_path(c, queries_np, ref_np, planted) -> dict:
    """Each family x reduction at PAPER through repro_torch.sdtw and an
    Aligner, each held to its plain version at PAPER's M and N: hard
    local on the full batch, the other five on every
    PLAIN_QUERY_STRIDE-th query of it."""
    torch = c.torch
    import repro_torch
    from repro_torch.core.normalize import normalize_batch
    from repro_torch.kernels import family, normalizer, ops, wavefront
    cfg = c.cfg
    w, m, n, B = cfg.segment_width, cfg.query_len, cfg.ref_len, cfg.batch
    qn = normalize_batch(torch.from_numpy(queries_np).to(c.dev))
    requests, launches, out = [], {}, {}
    for fam in ("twed", "erp", "local"):
        for soft in (False, True):
            spec = family_spec(fam, soft)
            var = family.variant(spec)
            for counter in (normalizer.counter, wavefront.counter,
                            wavefront.soft_counter, family.counter):
                counter.reset()
            t0 = time.perf_counter()
            res = repro_torch.sdtw(queries_np, ref_np, spec=spec,
                                   segment_width=w, device=c.dev,
                                   backend=c.backend)
            aligner = repro_torch.Aligner(ref_np, spec=spec,
                                          segment_width=w, device=c.dev,
                                          backend=c.backend)
            al = aligner(queries_np)
            c.sync()
            seconds = time.perf_counter() - t0
            got = {"normalizer": normalizer.counter.count,
                   "family_wavefront": dict(family.counter.by_variant),
                   "wavefront": dict(wavefront.counter.by_variant),
                   "soft_wavefront": dict(wavefront.soft_counter.by_variant)}
            require(not c.cuda or got == {
                "normalizer": 4, "family_wavefront": {var: 2},
                "wavefront": {}, "soft_wavefront": {}},
                f"{spec.describe()} launches {got}: want 4 normalizer "
                f"and {var} twice")
            launches[var] = launches.get(var, 0) + got[
                "family_wavefront"].get(var, 0)
            for x in (res.cost, res.end, al.cost, al.end):
                require(tuple(x.shape) == (B,), f"output shape {x.shape}")
            require(bool(torch.isfinite(res.cost).all()),
                    f"{spec.describe()}: non-finite cost")
            require(torch.equal(res.cost, al.cost)
                    and torch.equal(res.end, al.end),
                    f"{spec.describe()}: sdtw and Aligner disagree")
            info = {"spec": spec.describe(), "variant": var,
                    "seconds": seconds, "backend": aligner.backend.name,
                    "launches": got,
                    "cost_range": [float(res.cost.min()),
                                   float(res.cost.max())]}
            if fam == "local":
                planted_end = torch.from_numpy(planted).to(c.dev) + m - 1
                info["ends_at_planted_window_end"] = int(
                    (res.end.long() == planted_end).sum())
            else:
                require(bool((res.end == n - 1).all()),
                        f"{spec.describe()}: a corner end is not n - 1")
            # the plain version at PAPER's M and N on the same inputs:
            # the full batch for hard local, every PLAIN_QUERY_STRIDE-th
            # query for the other five
            stride = 1 if (fam == "local" and not soft) \
                else PLAIN_QUERY_STRIDE
            pq = qn[::stride].contiguous()
            layout = aligner.layout()
            extras = aligner.family_extras() + tuple(
                x[::stride].contiguous()
                for x in ops.family_extras_query(spec, qn))
            got_c, got_e = res.cost[::stride], res.end[::stride]
            shape = [pq.shape[0], m, n]
            c.sync()
            t0 = time.perf_counter()
            with torch.inference_mode():
                p_c, p_e = family.family_plain(pq, layout, extras, n=n,
                                               w=w, spec=spec)
            c.sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = float((got_c - p_c).abs().max())
            ok = torch.equal(got_e, p_e) and (
                bool(torch.allclose(got_c, p_c, rtol=1e-4, atol=1e-4))
                if soft else torch.equal(got_c, p_c))
            require(ok, f"{spec.describe()}: K7 differs from its plain "
                        f"version at {shape} (max abs {err})")
            info.update(plain_shape=shape, plain_ms=plain_ms,
                        max_abs_err=err,
                        parity="within atol=rtol=1e-4" if soft
                        else "bit-equal")
            requests.append(info)
            out[(fam, soft)] = {"spec": spec, "plain_ms": plain_ms,
                                "plain_shape": shape, "max_abs_err": err,
                                "aligner": aligner, "plain_inputs": (
                                    pq, extras)}
    emit({"phase": "family_main_path", "workload": {
              "batch": B, "query_len": m, "ref_len": n, "segment_width": w,
              "params": FAMILY_PARAMS, "gamma": FAMILY_GAMMA},
          "requests": requests, "launches": launches})
    return {"requests": out, "launches": launches, "qn": qn}


def family_times(c, fm: dict) -> dict:
    """K7 at PAPER for each family and reduction (CUDA events), on the
    plain version's queries beside its time, and the bounds."""
    from repro_torch.kernels import family, ops
    cfg = c.cfg
    w, m, n, B = cfg.segment_width, cfg.query_len, cfg.ref_len, cfg.batch
    qn = fm["qn"]
    rows = {}
    for (fam, soft), info in fm["requests"].items():
        spec, aligner = info["spec"], info["aligner"]
        layout = aligner.layout()
        extras = aligner.family_extras() + ops.family_extras_query(spec, qn)
        reps = (1 if soft else 2) if c.cuda else 1
        ms = c.timer(lambda: family.family_wavefront(
            qn, layout, extras, n=n, w=w, spec=spec), reps)
        pq, pex = info["plain_inputs"]
        ms_p = ms if pq.shape[0] == B else c.timer(
            lambda: family.family_wavefront(pq, layout, pex, n=n, w=w,
                                            spec=spec), reps)
        var = family.variant(spec)
        fp32, mufu = FAMILY_OPS[(var, fam)]
        cells = B * m * n
        in_bytes = (B * m + n) * 4 + (n * 4 if fam != "local" else 0) \
            + (B * m * 4 if fam == "erp" else 0)
        bound, by = least_time(c, in_bytes + B * 8, fp32 * cells,
                               mufu * cells)
        rows[(fam, soft)] = {
            "spec": spec.describe(), "variant": var, "ms": ms,
            "one_warp_ms": K7_ONE_WARP_MS[(fam, soft)],
            "ms_at_plain_shape": ms_p, "plain_ms": info["plain_ms"],
            "plain_shape": info["plain_shape"], "bound_ms": bound,
            "bound_by": by, "fp32_ops_a_cell": fp32,
            "mufu_ops_a_cell": mufu, "max_abs_err": info["max_abs_err"]}
    emit({"phase": "family_times", "clock": "cuda events" if c.cuda
          else "host clock (cpu rehearsal, not a device number)",
          "paper": {"batch": B, "query_len": m, "ref_len": n,
                    "segment_width": w},
          "one_warp_ms": "K7 at one warp per query, PERF.md's times of "
                         "record (NVIDIA H100 80GB HBM3, 700.00 W)",
          "rows": list(rows.values())})
    return rows


def bf16_phase(c, main_res, layout, qn) -> dict:
    """bf16-K1: every instantiation against its plain version; at PAPER
    through ops.sdtw_wavefront(compute_dtype=bfloat16), bit-equal to the
    plain version, ends against the float32 main path; the JAX bar
    (rtol 0.1, atol 0.3 against float32) at the JAX test's own shape."""
    np, torch = c.np, c.torch
    from repro_torch.core.normalize import normalize_batch
    from repro_torch.core.spec import DPSpec
    from repro_torch.kernels import ops, wavefront
    bf = torch.bfloat16
    rng = np.random.default_rng(c.seed + 7)

    def series(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return normalize_batch(x.to(c.dev))

    widths = wavefront.WIDTHS if c.cuda else (2, 4)
    checked = mismatches = 0
    B, m, n = (9, 200, 3000) if c.cuda else (3, 33, 300)
    q, r = series(B, m), series(n)
    for band in (None, 0, 900):
        for distance in ("sqeuclidean", "abs"):
            for window in (False, True):
                spec = DPSpec(band=band, distance=distance)
                want = wavefront.wavefront_plain(
                    q, wavefront.prepare_reference(r, 2), n=n, w=2,
                    spec=spec, with_window=window, compute_dtype=bf)
                for w in widths:
                    got = wavefront.wavefront(
                        q, wavefront.prepare_reference(r, w), n=n, w=w,
                        spec=spec, with_window=window, compute_dtype=bf)
                    c.sync()
                    checked += 1
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        mismatches += 1
                        emit({"phase": "bf16_mismatch", "w": w,
                              "band": band, "distance": distance,
                              "window": window,
                              "got": [a.tolist()[:4] for a in got],
                              "want": [a.tolist()[:4] for a in want]})
    require(mismatches == 0, f"{mismatches} bf16-K1 cases differ from the "
                             f"plain version")
    # the JAX package's own bar, at its test's shape (tests/
    # test_kernel_sdtw.py::test_bf16_compute: 2 x 16 against 256, w 4)
    jq, jr = series(2, 16), series(256)
    f32 = ops.sdtw_wavefront(jq, jr, segment_width=4)
    b16 = ops.sdtw_wavefront(jq, jr, segment_width=4, compute_dtype=bf)
    c.sync()
    bar_ok = bool(torch.allclose(b16[0], f32[0], rtol=0.1, atol=0.3))
    require(bar_ok, f"bf16 at the JAX test's shape off the float32 "
                    f"answer: {b16[0].tolist()} vs {f32[0].tolist()}")
    # PAPER through the entry point a user calls, counted alone
    cfg = c.cfg
    w, n = cfg.segment_width, cfg.ref_len
    wavefront.counter.reset()
    rn = main_res["reference"]
    got = ops.sdtw_wavefront(qn, rn, segment_width=w, compute_dtype=bf)
    c.sync()
    launches = dict(wavefront.counter.by_variant)
    require(not c.cuda or launches == {"bf16-K1": 1},
            f"bf16 path launches {launches}: want bf16-K1 once")
    t0 = time.perf_counter()
    want = wavefront.wavefront_plain(qn, layout, n=n, w=w, spec=DPSpec(),
                                     compute_dtype=bf)
    c.sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((got[0] - want[0]).abs().max())
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            f"bf16-K1 at PAPER differs from its plain version ({err})")
    f32c, f32e = main_res["cost"], main_res["end"]
    dev32 = (got[0] - f32c).abs()
    ms = c.timer(lambda: wavefront.wavefront(
        qn, layout, n=n, w=w, spec=DPSpec(), compute_dtype=bf),
        3 if c.cuda else 1)
    B, m = qn.shape
    bound, by = least_time(c, (B * m + n) * 4 + B * 8, 0.0,
                           bf16_ops=BF16_OPS_PER_CELL * B * m * n)
    info = {"phase": "bf16", "parity_cases": checked,
            "parity": "bit-equal to the plain version (the engine in "
                      "bf16, float32 fold)",
            "jax_bar_shape": [2, 16, 256], "jax_bar_ok": bar_ok,
            "jax_bar": "rtol=0.1, atol=0.3 against float32",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "paper_ends_equal_f32": int((got[1] == f32e).sum()),
            "paper_cost_vs_f32": {
                "max_abs": float(dev32.max()),
                "max_rel": float((dev32 / f32c.abs()).max()),
                "f32_mean": float(f32c.mean()),
                "bf16_mean": float(got[0].mean()),
                "within_jax_bar": int(torch.isclose(
                    got[0], f32c, rtol=0.1, atol=0.3).sum())}}
    require(info["paper_ends_equal_f32"] == B,
            f"bf16 ends at PAPER: {info['paper_ends_equal_f32']} of {B} "
            f"equal the float32 ends")
    emit(info)
    return info


def path_phase(c, queries_np, ref_np, planted, k3) -> dict:
    """Warping paths at PAPER's M and N: every PATH_STRIDE-th query (16
    of 512, planted windows all) through ``repro_torch.sdtw`` and an
    ``Aligner`` with ``outputs=("cost", "start", "end", "path")``, K3
    launches counted; each path starts at K3's start and ends at its
    end, takes unit steps, sums (float64) to K3's cost within 2e-3 and
    covers the planted window, and the first PATH_ORACLE paths equal the
    float64 full-matrix oracle over the window's slice."""
    np, torch = c.np, c.torch
    import repro_torch
    from repro_torch.align import oracle_path
    from repro_torch.align.traceback import host_f64
    from repro_torch.core.normalize import normalize_batch
    from repro_torch.kernels import normalizer, wavefront
    from repro_torch.obs import MetricsRegistry, Tracer
    B, m = c.cfg.batch, c.cfg.query_len
    idx = np.arange(0, B, max(1, B // PATH_QUERIES))[:PATH_QUERIES]
    q_sel = queries_np[idx]
    outputs = ("cost", "start", "end", "path")
    normalizer.counter.reset()
    wavefront.counter.reset()
    t0 = time.perf_counter()
    res = repro_torch.sdtw(q_sel, ref_np, outputs=outputs, device=c.dev,
                           backend=c.backend)
    sdtw_s = time.perf_counter() - t0
    tracer = Tracer(metrics=MetricsRegistry(), device_sync=True)
    aligner = repro_torch.Aligner(ref_np, device=c.dev, backend=c.backend,
                                  tracer=tracer)
    t0 = time.perf_counter()
    res_a = aligner(q_sel, outputs=outputs)
    aligner_s = time.perf_counter() - t0
    (dispatch,) = [e for e in tracer.events
                   if e["name"] == "aligner.dispatch"]
    launches = {"normalizer": normalizer.counter.count,
                "wavefront": dict(wavefront.counter.by_variant)}
    require(not c.cuda or launches == {"normalizer": 4,
                                       "wavefront": {"K3": 2}},
            f"path launches {launches}: want K3 once and K2 twice per "
            f"call")
    qn = host_f64(normalize_batch(torch.from_numpy(q_sel).to(c.dev)))
    rn = host_f64(aligner.reference)
    oracle_s = 0.0
    for k, b in enumerate(idx):
        start, end = int(res.start[k]), int(res.end[k])
        require(start == int(k3.start[b]) and end == int(k3.end[b]),
                f"query {b}: path window ({start}, {end}) is not the main "
                f"path's K3 window")
        for got in (res, res_a):
            path = got.path[k]
            require(np.array_equal(path, res.path[k]),
                    f"query {b}: sdtw and Aligner paths differ")
        path = res.path[k]
        require(tuple(path[0]) == (0, start) and
                tuple(path[-1]) == (m - 1, end),
                f"query {b}: path runs {tuple(path[0])} -> "
                f"{tuple(path[-1])}, window ({start}, {end})")
        steps = set(map(tuple, np.diff(path, axis=0).tolist()))
        require(steps <= {(0, 1), (1, 0), (1, 1)},
                f"query {b}: path steps {steps}")
        cost = float(((qn[k][path[:, 0]] - rn[path[:, 1]]) ** 2).sum())
        want = float(res.cost[k])
        require(abs(cost - want) <= 2e-3 + 2e-3 * abs(want),
                f"query {b}: path sums to {cost}, K3 cost {want}")
        require(path[0, 1] <= planted[b] and
                path[-1, 1] >= planted[b] + m - 1,
                f"query {b}: path misses the planted window at "
                f"{planted[b]}")
        if k < PATH_ORACLE:
            t0 = time.perf_counter()
            oracle = oracle_path(qn[k], rn[start:end + 1])
            oracle_s += time.perf_counter() - t0
            oracle[:, 1] += start
            require(np.array_equal(oracle, path),
                    f"query {b}: path differs from the float64 oracle")
    info = {"phase": "path", "queries": [int(b) for b in idx],
            "query_len": m, "ref_len": c.cfg.ref_len,
            "launches": launches, "path_cells": [len(p) for p in res.path],
            "checked": "start/end = K3's, unit steps, float64 sum within "
                       "2e-3 of K3's cost, planted window covered, sdtw "
                       "== Aligner",
            "oracle_equal_queries": [int(b) for b in idx[:PATH_ORACLE]],
            "oracle_s": oracle_s, "sdtw_s": sdtw_s, "aligner_s": aligner_s,
            "aligner_dispatch_ms": dispatch["dur_ns"] / 1e6,
            "traceback_s_per_query": (aligner_s - dispatch["dur_ns"] / 1e9)
            / len(idx),
            "traceback_clock": "host clock: the Aligner call less its "
                               "synchronized dispatch span (K2 and K3), "
                               "per query"}
    emit(info)
    return info


def tune_phase(c, queries_np, ref_np, k1, k3) -> dict:
    """``segment_width="auto"`` with ``REPRO_TORCH_TUNE_CACHE`` on a
    temporary file: cold kernel tunes of K1 and K3 at PAPER (each result
    bit-equal to w 8's), a fresh cache over the file answering both with
    0 trials and 1 hit, a warm auto ``Aligner`` call beside a warm w 8
    call, the unpinned kernel-against-engine tune at TUNE_SMALL with
    ``registry.select`` counting its verdict, and soft (K5) and twed (K7)
    auto calls there against w 8."""
    import os
    import tempfile
    np, torch = c.np, c.torch
    import repro_torch
    from repro_torch import obs, tune
    from repro_torch.backends import registry
    from repro_torch.configs.paper_sdtw import SDTWWorkload
    from repro_torch.core.result import sweep_outputs
    from repro_torch.core.spec import DPSpec, resolve_spec
    from repro_torch.kernels.ops import width_candidates
    cfg, dev = c.cfg, c.dev
    B, m, n = cfg.batch, cfg.query_len, cfg.ref_len
    reg = obs.default_registry()
    tmp = tempfile.mkdtemp(prefix="repro_torch_tune_")
    cache_file = os.path.join(tmp, "tuning.json")
    old_env = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = cache_file
    tune.set_default_cache(None, device=dev)   # reopen on the new file
    info = {"phase": "tune", "cache_file": "a temporary file "
            "(REPRO_TORCH_TUNE_CACHE)", "widths": list(
                width_candidates(n))}
    try:
        cold = {}
        for label, outputs, want in (("K1", ("cost", "end"), k1),
                                     ("K3", ("cost", "start", "end"), k3)):
            trials0 = reg.value("tune.trials")
            t0 = time.perf_counter()
            got = repro_torch.sdtw(queries_np, ref_np, backend="kernel",
                                   segment_width="auto", outputs=outputs,
                                   device=dev)
            c.sync()
            secs = time.perf_counter() - t0
            key = tune.workload_key(spec=DPSpec(), m=m, n=n,
                                    batch_bucket=tune.batch_bucket(B),
                                    outputs=sweep_outputs(outputs))
            verdict = tune.default_cache(dev).get(key)
            require(verdict is not None, f"{label}: no verdict cached")
            for o in outputs:
                require(torch.equal(getattr(got, o), getattr(want, o)),
                        f"{label} auto (w {verdict['segment_width']}) "
                        f"{o} differs from w 8's")
            measured = verdict["measured"]
            cold[label] = {
                "outputs": list(outputs), "seconds": secs,
                "trials": reg.value("tune.trials") - trials0,
                "winner_width": verdict["segment_width"],
                "winner_ms": verdict["best_ms"],
                "w8_ms": measured.get("kernel:w8"),
                "ms_by_width": dict(sorted(
                    (int(k.split("w", 1)[1]), v)
                    for k, v in measured.items())),
                "bit_equal_to_w8": True, "key": key}
        info["cold"] = cold
        # a fresh cache over the same file: the next process
        warm = {}
        fresh = tune.TuningCache(cache_file, device=dev)
        for label, outputs in (("K1", ("cost", "end")),
                               ("K3", ("cost", "start", "end"))):
            mreg = obs.MetricsRegistry()
            res = tune.autotune(ref_np, m=m, batch=B, outputs=outputs,
                                backends=("kernel",), device=dev,
                                cache=fresh, metrics=mreg)
            warm[label] = {"trials": mreg.value("tune.trials"),
                           "cache_hits": mreg.value("tune.cache_hits"),
                           "width": res.segment_width}
            require(warm[label]["trials"] == 0 and
                    warm[label]["cache_hits"] == 1 and res.from_cache,
                    f"{label}: a warm cache measured ({warm[label]})")
        info["warm_fresh_cache"] = warm
        # a warm auto Aligner call beside a warm w 8 call, alternated
        auto = repro_torch.Aligner(ref_np, segment_width="auto",
                                   device=dev, backend=c.backend)
        pinned = repro_torch.Aligner(ref_np, segment_width=8, device=dev,
                                     backend=c.backend)
        trials0 = reg.value("tune.trials")
        for a in (auto, pinned):
            got = a(queries_np)
            c.sync()
            require(torch.equal(got.cost, k1.cost) and
                    torch.equal(got.end, k1.end),
                    "auto Aligner differs from w 8's K1")
        require(reg.value("tune.trials") == trials0,
                "the auto Aligner measured on a warm cache")
        calls = {"auto": [], "w8": []}
        for _ in range(3):
            for label, a in (("auto", auto), ("w8", pinned)):
                t0 = time.perf_counter()
                a(queries_np)
                c.sync()
                calls[label].append((time.perf_counter() - t0) * 1e3)
        info["aligner_warm_ms"] = {
            "auto_width": auto.resolved_width((B, m)), "auto": calls["auto"],
            "w8": calls["w8"], "auto_min": min(calls["auto"]),
            "w8_min": min(calls["w8"]),
            "clock": "host clock around a call and a synchronize"}
        # kernel against engine, unpinned, at a small shape
        small = TUNE_SMALL if c.cuda else TUNE_SMALL_CPU
        sq, sr, _ = make_data(np, SDTWWorkload(
            batch=small[0], query_len=small[1], ref_len=small[2]),
            c.seed + 19)
        t0 = time.perf_counter()
        got = repro_torch.sdtw(sq, sr, segment_width="auto", device=dev)
        c.sync()
        secs = time.perf_counter() - t0
        key = tune.workload_key(spec=DPSpec(), m=small[1], n=small[2],
                                batch_bucket=tune.batch_bucket(small[0]),
                                outputs=frozenset({"cost", "end"}))
        verdict = tune.default_cache(dev).get(key)
        require(verdict is not None, "unpinned tune cached no verdict")
        before = reg.value(f"registry.select.{verdict['backend']}")
        chosen = registry.select(DPSpec(), outputs=("cost", "end"),
                                 device=dev, workload=(small[1], small[2],
                                                       small[0]))
        require(chosen.name == verdict["backend"] and
                reg.value(f"registry.select.{verdict['backend']}")
                == before + 1,
                f"registry.select chose {chosen.name}, the verdict "
                f"{verdict['backend']}")
        pin = repro_torch.sdtw(sq, sr, backend=verdict["backend"],
                               segment_width=verdict["segment_width"],
                               device=dev)
        require(torch.equal(got.cost, pin.cost),
                "unpinned auto differs from its verdict's plan")
        info["unpinned"] = {
            "shape": list(small), "seconds": secs,
            "winner": verdict["backend"],
            "winner_width": verdict["segment_width"],
            "ms": verdict["measured"], "select": chosen.name}
        # soft (K5) and twed (K7) at the small shape, against w 8
        others = {}
        for label, kw, exact in (
                ("K5", dict(gamma=PAPER_GAMMA), False),
                ("K7-corner twed", dict(family="twed",
                                        **FAMILY_PARAMS["twed"]), True)):
            t0 = time.perf_counter()
            got = repro_torch.sdtw(sq, sr, backend="kernel",
                                   segment_width="auto", device=dev, **kw)
            c.sync()
            secs = time.perf_counter() - t0
            want = repro_torch.sdtw(sq, sr, backend="kernel",
                                    segment_width=8, device=dev, **kw)
            err = float((got.cost - want.cost).abs().max())
            if exact:
                require(torch.equal(got.cost, want.cost) and
                        torch.equal(got.end, want.end),
                        f"{label} auto differs from w 8")
            else:
                require(bool(torch.allclose(got.cost, want.cost, rtol=1e-6,
                                            atol=1e-6)),
                        f"{label} auto off w 8 by {err}")
            v = tune.default_cache(dev).get(tune.workload_key(
                spec=resolve_spec(None, **kw), m=small[1], n=small[2],
                batch_bucket=tune.batch_bucket(small[0]),
                outputs=frozenset({"cost", "end"})))
            require(v is not None, f"{label}: no verdict cached")
            others[label] = {"seconds": secs, "trials": v["trials"],
                             "winner_width": v["segment_width"],
                             "ms": v["measured"], "max_abs_err_vs_w8": err,
                             "rule": "bit-equal" if exact else
                             "atol=rtol=1e-6"}
        info["small_auto"] = others
    finally:
        tune.set_default_cache(None, device=dev)
        if old_env is None:
            os.environ.pop("REPRO_TORCH_TUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_TUNE_CACHE"] = old_env
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    emit(info)
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at the SMALL size with the "
                         "plain versions; prints no verdict")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import numpy as np
    import torch
    if not args.cpu and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs one CUDA card (--cpu rehearses on the CPU)",
              file=sys.stderr)
        return 1

    import repro_torch
    from repro_torch.configs.paper_sdtw import PAPER, SMALL
    from repro_torch.core.normalize import normalize_batch
    from repro_torch.core.ref import sdtw_numpy
    from repro_torch.core.spec import DPSpec
    from repro_torch.kernels import build, family, normalizer, ops, wavefront

    cuda = not args.cpu
    dev = torch.device("cuda" if cuda else "cpu")
    cfg = PAPER if cuda else SMALL
    timer = Timer(torch, cuda)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ------------------------------------------------ 1. card and build
    smi = nvidia_smi() if cuda else "cpu rehearsal (no card)"
    print(smi, flush=True)
    clock_idle, clock_max = sm_clocks_mhz() if cuda else (None, None)
    lane_ops_per_s = FP32_LANES * clock_max * 1e6 if cuda else None
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0) if cuda else "cpu",
          "config": "PAPER" if cuda else "SMALL"})
    ptxas = {}
    if cuda:
        t0 = time.perf_counter()
        logs = build.build_all()
        seconds = time.perf_counter() - t0
        ptxas = ptxas_summary(logs)
        out_dir = Path(__file__).resolve().parent / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "ptxas.json").write_text(json.dumps(ptxas, indent=1))
        emit({"phase": "build", "seconds": seconds,
              "libraries": sorted(logs),
              "ptxas_by_library": {
                  name: {"instantiations": len(rows),
                         "registers_max": max(r.get("registers", 0)
                                              for r in rows),
                         "spill_bytes": sum(r.get("spill_stores", 0)
                                            + r.get("spill_loads", 0)
                                            for r in rows)}
                  for name, rows in ptxas.items()},
              "ptxas_table": "chiprun_out/ptxas.json"})
        # every instantiation of K5/K6 (6 widths x reverse x band x
        # distance) and of hard and soft K7 (6 widths x 3 families x band
        # x distance) reports, and none spills
        for lib, key, want in (("soft_wavefront", "reverse", 48),
                               ("family_wavefront", "family", 72),
                               ("soft_family_wavefront", "family", 72)):
            rows = [r for r in ptxas.get(lib, []) if key in r]
            require(len(rows) == want,
                    f"ptxas reports {len(rows)} {lib} instantiations, "
                    f"not {want}")
            require(all(r.get("spill_stores", 0) + r.get("spill_loads", 0)
                        == 0 for r in rows),
                    f"a {lib} instantiation spills registers")

    queries_np, ref_np, planted = make_data(np, cfg, args.seed)
    q_raw = torch.from_numpy(queries_np).to(dev)
    r_raw = torch.from_numpy(ref_np).to(dev)

    # ------------------------------------------------ 2. K2 parity
    k2_main = {}
    k2_rng = np.random.default_rng(args.seed + 8)
    shapes = [("queries", q_raw), ("reference", r_raw[None])]
    # both kernels at ragged lengths, rows not 16-byte aligned (n not a
    # multiple of 4, and a view one float into its buffer)
    for rows in (1, 513):
        for n_k2 in (K2_LENGTHS if cuda else (1, 31, 2001)):
            flat = torch.from_numpy((k2_rng.normal(size=rows * n_k2 + 1) * 3
                                     + 1).astype(np.float32)).to(dev)
            shapes.append((f"{rows}x{n_k2}", flat[:-1].view(rows, n_k2)))
            shapes.append((f"{rows}x{n_k2}+1", flat[1:].view(rows, n_k2)))
    k2_worst = 0.0
    for label, x in shapes:
        got, got_stats = normalizer.normalize_cuda(x, with_stats=True) \
            if cuda else normalizer.normalize_plain(x, with_stats=True)
        want, want_stats = normalizer.normalize_plain(x, with_stats=True)
        sync()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, atol=1e-5, rtol=1e-5)
                  and torch.allclose(got_stats, want_stats, atol=1e-5,
                                     rtol=1e-5))
        k2_worst = max(k2_worst, err)
        if label in ("queries", "reference"):
            k2_main[label] = {"shape": list(x.shape), "max_abs_err": err,
                              "ok": ok}
        require(ok, f"K2 {label}: max abs err {err} over atol=rtol=1e-5")
    emit({"phase": "k2_parity", "tolerance": "atol=rtol=1e-5 (y and the "
          "(mean, var) stats)", **k2_main, "shapes": [lb for lb, _ in shapes],
          "worst_abs_err": k2_worst})

    # ------------------------------------------------ 3. K1/K3/K4 parity
    t_parity = time.perf_counter()
    rng = np.random.default_rng(args.seed + 1)
    m_long = cfg.query_len
    sets = [(1, 33, 50), (9, 33, 3000), (64, m_long, 3000),
            (9, m_long, 50)]
    bands = (None, 0, 64, 900)
    checked = mismatches = blocked_checked = 0
    launches_before = wavefront.counter.count
    for B, m, n in sets:
        q = normalize_batch(torch.from_numpy(
            rng.normal(size=(B, m)).astype(np.float32)).to(dev))
        r = normalize_batch(torch.from_numpy(
            rng.normal(size=(n,)).astype(np.float32)).to(dev))
        for band in bands:
            for distance in ("sqeuclidean", "abs"):
                if distance == "abs" and m != 33 and band != 900:
                    continue       # enough for every abs instantiation
                spec = DPSpec(band=band, distance=distance)
                # one plain sweep with the start lane: K1 is held to its
                # cost and end, K3 to all three
                layout2 = wavefront.prepare_reference(r, 2)
                want3 = wavefront.wavefront_plain(
                    q, layout2, n=n, w=2, spec=spec, with_window=True)
                for window in (False, True):
                    want = want3 if window else (want3[0], want3[2])
                    if ops.band_blocked(m, n, band):
                        before = wavefront.counter.count
                        got = ops.sdtw_wavefront_prepped(
                            q, layout2, n=n, segment_width=2, spec=spec,
                            return_window=window)
                        sync()
                        require(wavefront.counter.count == before,
                                "blocked band launched the kernel")
                        require(all(torch.equal(a, b)
                                    for a, b in zip(got, want)),
                                f"blocked band {(B, m, n, band)} differs "
                                f"from the plain version")
                        blocked_checked += 1
                        continue
                    for w in wavefront.WIDTHS:
                        got = wavefront.wavefront(
                            q, wavefront.prepare_reference(r, w), n=n,
                            w=w, spec=spec, with_window=window)
                        sync()
                        checked += 1
                        if not all(torch.equal(a, b)
                                   for a, b in zip(got, want)):
                            mismatches += 1
                            emit({"phase": "k1_mismatch", "B": B, "m": m,
                                  "n": n, "band": band, "w": w,
                                  "distance": distance, "window": window,
                                  "got": [a.tolist()[:4] for a in got],
                                  "want": [a.tolist()[:4] for a in want]})
    # chunk counts around the warps of a CTA (P): 1, P-1, P, P+1 and 2P+1
    # chunks at every width (idle warps, a ring that wraps), m 1 and 33;
    # one plain version per reference, K1 held to its cost and end
    P = wavefront.WARPS
    chunk_cases = 0
    for m_c in (1, 33):
        for w_c in (wavefront.WIDTHS if cuda else (2,)):
            W_c = wavefront.chunk_cols(w_c)
            for k in (1, P - 1, P, P + 1, 2 * P + 1):
                n_c = (k - 1) * W_c + W_c // 2 + 3
                q = normalize_batch(torch.from_numpy(
                    rng.normal(size=(3, m_c)).astype(np.float32)).to(dev))
                r = normalize_batch(torch.from_numpy(
                    rng.normal(size=(n_c,)).astype(np.float32)).to(dev))
                lay = wavefront.prepare_reference(r, w_c)
                want = wavefront.wavefront_plain(q, lay, n=n_c, w=w_c,
                                                 spec=DPSpec(),
                                                 with_window=True)
                for window in (False, True):
                    got = wavefront.wavefront(q, lay, n=n_c, w=w_c,
                                              spec=DPSpec(),
                                              with_window=window)
                    sync()
                    checked += 1
                    chunk_cases += 1
                    ref = want if window else (want[0], want[2])
                    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                        mismatches += 1
                        emit({"phase": "k1_mismatch", "B": 3, "m": m_c,
                              "n": n_c, "chunks": k, "w": w_c,
                              "window": window,
                              "got": [a.tolist()[:4] for a in got],
                              "want": [a.tolist()[:4] for a in ref]})
    # the float64 oracle on a small input
    q_small = normalize_batch(torch.from_numpy(
        rng.normal(size=(3, 33)).astype(np.float32)).to(dev))
    r_small = normalize_batch(torch.from_numpy(
        rng.normal(size=(200,)).astype(np.float32)).to(dev))
    c_small, e_small = ops.sdtw_wavefront(q_small, r_small,
                                          segment_width=8)
    oracle = [sdtw_numpy(q_small[b].cpu().numpy(), r_small.cpu().numpy())
              for b in range(3)]
    oracle_ok = all(abs(float(c_small[b]) - c) <= 2e-3 + 2e-3 * abs(c)
                    and int(e_small[b]) == e
                    for b, (c, e) in enumerate(oracle))
    emit({"phase": "k1_k3_k4_parity", "rule": "bit-equal to the plain "
          "version (cost, end, start)", "cases": checked,
          "chunk_count_cases": chunk_cases, "warps_per_cta": P,
          "seconds": time.perf_counter() - t_parity,
          "mismatches": mismatches, "blocked_band_cases": blocked_checked,
          "launches": wavefront.counter.count - launches_before,
          "oracle_float64_ok": oracle_ok})
    require(mismatches == 0, f"{mismatches} wavefront cases differ from "
                             f"the plain version")
    require(oracle_ok, "wavefront disagrees with the float64 oracle")

    # ------------------------------------------------ 4. main path
    w = cfg.segment_width
    m, n, B = cfg.query_len, cfg.ref_len, cfg.batch
    normalizer.counter.reset()
    wavefront.counter.reset()
    t0 = time.perf_counter()
    # on the card the registry picks the kernel backend by itself; the
    # CPU rehearsal names it, since there the engine would lead
    backend = None if cuda else "kernel"
    res = repro_torch.sdtw(queries_np, ref_np, segment_width=w, device=dev,
                           backend=backend)
    aligner = repro_torch.Aligner(ref_np, segment_width=w, device=dev,
                                  backend=backend)
    win = aligner(queries_np, outputs=("cost", "start", "end"))
    sync()
    main_s = time.perf_counter() - t0
    launches = {"normalizer": normalizer.counter.count,
                "normalizer_by_kernel": dict(normalizer.counter.by_variant),
                "wavefront": dict(wavefront.counter.by_variant)}
    require(not cuda or (launches["normalizer"] == 4
                         and launches["normalizer_by_kernel"] == {
                             "rows": 2, "cluster": 2}
                         and launches["wavefront"] == {"K1": 1, "K3": 1}),
            f"main path launches {launches}: want 4 normalizer (the rows "
            f"kernel on the queries, the cluster kernel on the reference, "
            f"per call), K1 once and K3 once")
    for out in (res.cost, res.end, win.cost, win.start, win.end):
        require(tuple(out.shape) == (B,), f"output shape {out.shape}")
    require(bool(torch.isfinite(res.cost).all()), "non-finite cost")
    planted_t = torch.from_numpy(planted).to(dev)
    found = int(((win.start.long() == planted_t)
                 & (win.end.long() == planted_t + m - 1)).sum())
    require(found == B, f"{found} of {B} planted windows found")
    require(bool((res.end.long() == planted_t + m - 1).all()),
            "sdtw ends differ from the planted windows")
    require(torch.equal(res.cost, win.cost) and torch.equal(res.end,
                                                            win.end),
            "sdtw and Aligner disagree")
    # the whole main-path output against the plain version, bit for bit
    qn = normalize_batch(q_raw)
    layout = aligner.layout()
    sync()
    t0 = time.perf_counter()
    plain_k1 = wavefront.wavefront_plain(qn, layout, n=n, w=w,
                                         spec=DPSpec())
    sync()
    plain_k1_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain_k3 = wavefront.wavefront_plain(qn, layout, n=n, w=w,
                                         spec=DPSpec(), with_window=True)
    sync()
    plain_k3_ms = (time.perf_counter() - t0) * 1e3
    k1_err = float((res.cost - plain_k1[0]).abs().max())
    k3_err = float((win.cost - plain_k3[0]).abs().max())
    require(torch.equal(res.cost, plain_k1[0])
            and torch.equal(res.end, plain_k1[1]),
            f"K1 main path differs from the plain version ({k1_err})")
    require(all(torch.equal(a, b) for a, b in
                zip((win.cost, win.start, win.end), plain_k3)),
            f"K3 main path differs from the plain version ({k3_err})")
    emit({"phase": "main_path", "workload": {"batch": B, "query_len": m,
          "ref_len": n, "segment_width": w}, "seconds": main_s,
          "backend": aligner.backend.name,
          "launches": launches, "planted_found": found,
          "plain_bit_equal_queries": B, "stats": aligner.stats.as_dict()})

    # the banded path through the same entry point: K4, counted alone
    normalizer.counter.reset()
    wavefront.counter.reset()
    banded = repro_torch.sdtw(queries_np, ref_np, band=BAND,
                              segment_width=w, device=dev, backend=backend)
    sync()
    band_launches = {"normalizer": normalizer.counter.count,
                     "wavefront": dict(wavefront.counter.by_variant)}
    require(not cuda or band_launches == {"normalizer": 2,
                                          "wavefront": {"K4": 1}},
            f"banded path launches {band_launches}: want 2 normalizer "
            f"and K4 once")
    band_spec = DPSpec(band=BAND)
    t0 = time.perf_counter()
    plain_k4 = wavefront.wavefront_plain(qn, layout, n=n, w=w,
                                         spec=band_spec)
    sync()
    plain_k4_ms = (time.perf_counter() - t0) * 1e3
    k4_err = float((banded.cost - plain_k4[0]).abs().max())
    require(torch.equal(banded.cost, plain_k4[0])
            and torch.equal(banded.end, plain_k4[1]),
            f"K4 banded path differs from the plain version ({k4_err})")
    require(bool(torch.isfinite(banded.cost).all()
                 & (banded.end <= m - 1 + BAND).all()),
            "banded path: a non-finite cost or an end outside the band")
    k4_chunks = wavefront.band_grid_chunks(
        m, BAND, layout.shape[0] // wavefront.chunk_cols(w), w)
    emit({"phase": "banded_path", "band": BAND, "launches": band_launches,
          "chunks_visited": k4_chunks,
          "chunks_unbanded": layout.shape[0] // wavefront.chunk_cols(w),
          "plain_bit_equal_queries": B})

    # ------------------------------------------------ 5. times
    spec = DPSpec()
    reps = 3 if cuda else 1
    k1_ms = timer(lambda: wavefront.wavefront(qn, layout, n=n, w=w,
                                              spec=spec), reps)
    k3_ms = timer(lambda: wavefront.wavefront(qn, layout, n=n, w=w,
                                              spec=spec, with_window=True),
                  reps)
    # small kernels: device time from a CUDA graph of GRAPH_LAUNCHES
    # launches, beside the host-paced time of 20 calls between two events
    k4_fn = lambda: wavefront.wavefront(qn, layout, n=n, w=w,  # noqa: E731
                                        spec=band_spec)
    k4_ms = graph_ms(torch, k4_fn, cuda)
    k4_host_ms = timer(k4_fn, 20)
    width_ms = {}
    for ww in wavefront.WIDTHS:
        lay = wavefront.prepare_reference(aligner.reference, ww)
        width_ms[ww] = timer(lambda: wavefront.wavefront(
            qn, lay, n=n, w=ww, spec=spec), reps)
    best_w = min(width_ms, key=width_ms.get)
    qc = q_raw.contiguous()
    rc = r_raw[None].contiguous()
    k2 = {}
    for label, x in (("queries", qc), ("reference", rc)):
        fns = {"ms": lambda: normalizer.normalize(x),
               "library_ms": lambda: torch.nn.functional.layer_norm(
                   x, (x.shape[-1],), eps=1e-12),
               "plain_ms": lambda: normalizer.normalize_plain(x)}
        k2[label] = {key: graph_ms(torch, fn, cuda)
                     for key, fn in fns.items()}
        k2[label].update({f"{key}_host_paced": timer(fn, 20)
                          for key, fn in fns.items()})
        k2[label]["geometry"] = normalizer.geometry(*x.shape)._asdict()
        k2[label]["bound_ms"], k2[label]["bound_by"] = None, "bytes"

    def warm_call():
        aligner(queries_np)
        sync()
    t0 = time.perf_counter()
    warm_call()
    aligner_ms = (time.perf_counter() - t0) * 1e3
    # the SM clock under load: read while three K1 launches are queued
    clock_now = None
    if cuda:
        for _ in range(3):
            wavefront.wavefront(qn, layout, n=n, w=w, spec=spec)
        clock_now, _ = sm_clocks_mhz()
        sync()

    def bound(n_bytes: float, ops: float):
        """Least time (ms) and what bounds it: bytes over the memory
        rate against operations over the lane issue rate."""
        if not cuda:
            return None, "operations"
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / lane_ops_per_s * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                     else "operations")
    cells = B * m * n
    k4_cells = B * band_cells(np, m, n, BAND)
    sweep_bytes = (B * m + n) * 4 + B * 8            # in once, out once
    k1_bound, k1_by = bound(sweep_bytes, cells * K1_OPS_PER_CELL)
    k3_bound, k3_by = bound(sweep_bytes + B * 4, cells * K3_OPS_PER_CELL)
    k4_bound, k4_by = bound(sweep_bytes, k4_cells * K1_OPS_PER_CELL)
    for label, x in (("queries", qc), ("reference", rc)):
        k2[label]["bound_ms"], k2[label]["bound_by"] = bound(
            2 * x.numel() * 4, K2_OPS_PER_ELEMENT * x.numel())
    # the launch geometry of the main path's kernels
    geometry = {}
    for label, windowed in (("K1", False), ("K3", True)):
        geo = wavefront.hard_geometry(m, windowed)
        geometry[label] = {
            "warps_per_cta": geo.warps, "ring_rows": geo.ring_rows,
            "ring_groups": geo.slots, "smem_bytes_per_cta": geo.smem_bytes,
            "ctas": B, "ctas_resident_per_sm": wavefront.hard_occupancy(
                m, w, with_window=windowed) if cuda else None}
    k56_regs = {(r.get("reverse"), r.get("w")): r.get("registers")
                for r in ptxas.get("soft_wavefront", [])
                if not r.get("band") and not r.get("abs")}
    for label, reverse in (("K5/K6-forward", False), ("K6-reverse", True)):
        geo = wavefront.soft_ring_geometry(m)
        geometry[label] = {
            "warps_per_cta": geo.warps, "ring_rows": geo.ring_rows,
            "ring_groups": geo.slots, "smem_bytes_per_cta": geo.smem_bytes,
            "registers": k56_regs.get((reverse, w)), "ctas": B,
            "ctas_resident_per_sm": wavefront.soft_occupancy(
                m, w, reverse=reverse) if cuda else None,
            "longest_query": wavefront.longest_query(soft_spec(1.0))}
    for soft in (False, True):
        k7_regs = {(r.get("family"), r.get("w")): r.get("registers")
                   for r in ptxas.get(family.library_name(soft), [])
                   if not r.get("band") and not r.get("abs")}
        for fam in ("twed", "erp", "local"):
            geo = family.family_geometry(m, fam)
            geometry[f"K7{'-soft' if soft else ''} {fam}"] = {
                "warps_per_cta": geo.warps, "ring_rows": geo.ring_rows,
                "ring_groups": geo.slots,
                "smem_bytes_per_cta": geo.smem_bytes,
                "registers": k7_regs.get((fam, w)), "ctas": B,
                "ctas_resident_per_sm": family.family_occupancy(
                    m, w, fam, soft=soft) if cuda else None}
    for label in ("queries", "reference"):
        geo = k2[label]["geometry"]
        geometry[f"K2 {label}"] = {
            "kernel": "cluster" if geo["cluster"] else "rows",
            "cluster_ctas": geo["cluster"], "float4_per_thread": geo["vec"],
            "threads_per_cta": geo["threads"], "ctas": geo["grid"]}
    emit({"phase": "geometry", "segment_width": w, "query_len": m,
          **geometry, "registers": "chiprun_out/ptxas.json"})
    emit({"phase": "times", "clock": "cuda events" if cuda
          else "host clock (cpu rehearsal, not a device number)",
          "nvidia_smi": smi, "k1_ms": k1_ms, "k3_ms": k3_ms,
          "k4_ms": k4_ms, "k4_host_paced_ms": k4_host_ms, "k4_band": BAND,
          "small_kernels": f"ms: device time, a CUDA graph of "
                           f"{GRAPH_LAUNCHES} launches replayed "
                           f"{GRAPH_REPLAYS} times; *_host_paced: 20 calls "
                           f"between two events, paced by the host",
          "k1_ms_by_width": width_ms, "best_width": best_w,
          "k1_plain_ms": plain_k1_ms, "k3_plain_ms": plain_k3_ms,
          "k4_plain_ms": plain_k4_ms, "k2": k2,
          "aligner_warm_call_ms": aligner_ms,
          "k1_bound_ms": k1_bound, "k3_bound_ms": k3_bound,
          "k4_bound_ms": k4_bound,
          "cells": cells, "k4_cells_in_band": k4_cells,
          "k4_cells_visited": B * m * k4_chunks * wavefront.chunk_cols(w),
          "sm_clock_mhz_idle": clock_idle,
          "sm_clock_mhz_under_load": clock_now, "sm_clock_max_mhz": clock_max,
          "lane_ops_per_s": lane_ops_per_s})

    # ------------------------------------------ 6.-10. soft-min phases
    ctx = argparse.Namespace(
        np=np, torch=torch, dev=dev, cuda=cuda, cfg=cfg, timer=timer,
        sync=sync, seed=args.seed, backend=backend,
        clock_max=clock_max, lane_ops_per_s=lane_ops_per_s)
    soft_parity(ctx)
    main_soft = soft_main_path(ctx, queries_np, ref_np, planted)
    train = train_path(ctx)
    soft_alignment_phase(ctx)
    soft = soft_times(ctx, main_soft, train)

    # ---------------------------------- 11.-14. families and bf16-K1
    family_parity(ctx)
    fam_main = family_main_path(ctx, queries_np, ref_np, planted)
    fam_rows = family_times(ctx, fam_main)
    bf = bf16_phase(ctx, {"reference": aligner.reference, "cost": res.cost,
                          "end": res.end}, layout, qn)

    # ----------------------------------- 15.-16. warping paths, tuning
    path_phase(ctx, queries_np, ref_np, planted, win)
    tune_phase(ctx, queries_np, ref_np, res, win)

    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})

    # ------------------------------------------------ 17. kernels line
    cu = "src/repro_torch/kernels/csrc/"
    k7 = []
    for key, name in ((("twed", False), "K7-corner"),
                      (("local", False), "K7-cells"),
                      (("twed", True), "K7-soft-corner"),
                      (("local", True), "K7-soft-cells")):
        row = fam_rows[key]
        k7.append({
            "name": f"family_wavefront_{name}", "route": "cuda",
            "source": cu + "family_wavefront.cu",
            "replaces": "src/repro/kernels/wavefront.py:967",
            "path": f"repro_torch.sdtw and Aligner, {row['spec']} at PAPER "
                    f"(ms and launches; bound at PAPER); plain_ms at "
                    f"{row['plain_shape']}, beside ms_at_plain_shape",
            "launches": fam_main["launches"].get(name, 0),
            "parity": "within atol=rtol=1e-4 of the plain version"
            if key[1] else "bit-equal to the plain version",
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "ms_at_plain_shape": row["ms_at_plain_shape"],
            "plain_ms": row["plain_ms"], "plain_shape": row["plain_shape"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
    k7.append({
        "name": "wavefront_bf16_K1", "route": "cuda",
        "source": cu + "wavefront.cu",
        "replaces": "src/repro/kernels/wavefront.py:967",
        "path": "repro_torch.kernels.ops.sdtw_wavefront(compute_dtype="
                "torch.bfloat16) at PAPER",
        "launches": bf["launches"].get("bf16-K1", 0),
        "parity": "bit-equal to the plain version",
        "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
        "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
        "bound_by": bf["bound_by"], "library_ms": None})
    emit({"kernels": [
        {"name": "wavefront_K1", "route": "cuda",
         "source": cu + "wavefront.cu",
         "replaces": "src/repro/kernels/wavefront.py:967",
         "launches": launches["wavefront"].get("K1", 0),
         "parity": "bit-equal to the plain version",
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": plain_k1_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "wavefront_K3", "route": "cuda",
         "source": cu + "wavefront.cu",
         "replaces": "src/repro/kernels/wavefront.py:967",
         "launches": launches["wavefront"].get("K3", 0),
         "parity": "bit-equal to the plain version",
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": plain_k3_ms,
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
        {"name": "wavefront_K4", "route": "cuda",
         "source": cu + "wavefront.cu",
         "replaces": "src/repro/kernels/wavefront.py:967",
         "path": f"repro_torch.sdtw(band={BAND})",
         "launches": band_launches["wavefront"].get("K4", 0),
         "parity": "bit-equal to the plain version",
         "max_abs_err": k4_err, "ms": k4_ms,
         "timing": "device time, CUDA graph",
         "ms_host_paced": k4_host_ms, "plain_ms": plain_k4_ms,
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None},
        {"name": "normalizer_K2_rows", "route": "cuda",
         "source": cu + "normalizer.cu",
         "replaces": "src/repro/kernels/normalizer.py:48",
         "path": "the query batch (512, 2000) of the main path",
         "launches": launches["normalizer_by_kernel"].get("rows", 0),
         "parity": "within atol=rtol=1e-5 of the plain version",
         "max_abs_err": k2_main["queries"]["max_abs_err"], "ms": k2["queries"]["ms"],
         "timing": "device time, CUDA graph (ms, plain_ms, library_ms)",
         "ms_host_paced": k2["queries"]["ms_host_paced"],
         "plain_ms": k2["queries"]["plain_ms"],
         "bound_ms": k2["queries"]["bound_ms"],
         "bound_by": k2["queries"]["bound_by"],
         "library_ms": k2["queries"]["library_ms"]},
        {"name": "normalizer_K2_cluster", "route": "cuda",
         "source": cu + "normalizer.cu",
         "replaces": "src/repro/kernels/normalizer.py:48",
         "path": "the reference (1, 100000) of the main path",
         "launches": launches["normalizer_by_kernel"].get("cluster", 0),
         "parity": "within atol=rtol=1e-5 of the plain version",
         "max_abs_err": k2_main["reference"]["max_abs_err"], "ms": k2["reference"]["ms"],
         "timing": "device time, CUDA graph (ms, plain_ms, library_ms)",
         "ms_host_paced": k2["reference"]["ms_host_paced"],
         "plain_ms": k2["reference"]["plain_ms"],
         "bound_ms": k2["reference"]["bound_ms"],
         "bound_by": k2["reference"]["bound_by"],
         "library_ms": k2["reference"]["library_ms"]},
        {"name": "soft_wavefront_K5", "route": "cuda",
         "source": cu + "wavefront.cu",
         "replaces": "src/repro/kernels/wavefront.py:967",
         "path": "repro_torch.sdtw(reduction='softmin') at PAPER",
         "launches": main_soft["launches"]["soft_wavefront"].get("K5", 0),
         "parity": "within atol=rtol=1e-4 of the plain version",
         "max_abs_err": main_soft["max_abs_err"], "ms": soft["k5_ms"],
         "plain_ms": main_soft["plain_ms"], "bound_ms": soft["k5_bound_ms"],
         "bound_by": soft["k5_bound_by"], "library_ms": None},
        {"name": "soft_wavefront_K6_forward", "route": "cuda",
         "source": cu + "wavefront.cu",
         "replaces": "src/repro/kernels/wavefront.py:967",
         "path": "make_sdtw_loss backward at the training shape",
         "launches": train["launches"]["soft_wavefront"].get(
             "K6-forward", 0),
         "parity": "within atol=rtol=1e-4 of the plain version",
         "max_abs_err": soft["k6f_max_abs_err"],
         "ms": soft["k6f_train_ms"], "plain_ms": soft["k6f_plain_ms"],
         "bound_ms": soft["k6f_bound_ms"], "bound_by": soft["k6_bound_by"],
         "library_ms": None},
        {"name": "soft_wavefront_K6_reverse", "route": "cuda",
         "source": cu + "wavefront.cu",
         "replaces": "src/repro/kernels/wavefront.py:967",
         "path": "make_sdtw_loss backward at the training shape",
         "launches": train["launches"]["soft_wavefront"].get(
             "K6-reverse", 0),
         "parity": "within atol=rtol=1e-4 of the plain version",
         "max_abs_err": soft["k6r_max_abs_err"],
         "ms": soft["k6r_train_ms"], "plain_ms": soft["k6r_plain_ms"],
         "bound_ms": soft["k6r_bound_ms"], "bound_by": soft["k6_bound_by"],
         "library_ms": None},
    ] + k7})
    if not cuda:
        return 0
    require(all(launches["normalizer_by_kernel"].get(k, 0) > 0
                for k in ("rows", "cluster")) and launches["wavefront"]
            and band_launches["wavefront"],
            "a kernel of the main path was never launched")
    require(main_soft["launches"]["soft_wavefront"].get("K5", 0) > 0
            and all(train["launches"]["soft_wavefront"].get(k, 0) > 0
                    for k in ("K6-forward", "K6-reverse"))
            and train["launches"]["normalizer"] > 0,
            "a kernel of the soft or training path was never launched")
    require(all(k["launches"] > 0 for k in k7),
            "a K7 variant or bf16-K1 was never launched on its path")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
