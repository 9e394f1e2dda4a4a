#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py            # on the card: build, check, time
    python3 chip_smoke.py --cpu      # rehearsal on the CPU, small size,
                                     # plain versions, no verdict line

Phases, one JSON line each:
  1. the card (``nvidia-smi`` name and power limit) and the kernel build
     (``nvcc -Xptxas -v``: registers and spills per instantiation);
  2. K2 (normalizer kernel) against its plain version on the PAPER query
     batch (512, 2000) and reference (100,000,), atol = rtol = 1e-5;
  3. K1/K3/K4 (wavefront kernel) against its plain version, bit for bit:
     batches 1, 9, 64; m = 33 and 2000; references of one and several
     chunks with ragged tails; every instantiated width; bands None, 0,
     64 and 900 (band-skip, and the blocked band answered with no
     launch); both distances — every one of the 48 instantiations runs
     on a multi-chunk reference; plus the float64 oracle on a small
     input;
  4. the main path at full PAPER width: ``repro_torch.sdtw`` and an
     ``Aligner`` on 512 queries x 2,000 against 100,000, every planted
     window found, launch counts read from the wrappers, and the whole
     output held against the plain version bit for bit; then the banded
     path (``repro_torch.sdtw(..., band=900)``, K4) on the same data,
     its counts read on their own, bit for bit against the plain version;
  5. times from CUDA events (warm): K1, K3 and K4 at PAPER, every width,
     K2, a warm ``Aligner`` call; the plain versions' times and the K2
     yardstick ``torch.nn.functional.layer_norm``; each kernel's bound;
  6. the ``kernels`` line.
The last line is the verdict ``{"ok": true, "device": {...}}``, printed
only when every phase passed on the card.  Any failure raises and exits
non-zero.  With no card (and no ``--cpu``) the script exits 1 at once.
"""

from __future__ import annotations

import argparse
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
                if t:
                    current.update(w=int(t.group(1)),
                                   window=bool(int(t.group(2))),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at the SMALL size with the "
                         "plain versions; prints no verdict")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

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
    from repro_torch.kernels import build, normalizer, ops, wavefront

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
    if cuda:
        t0 = time.perf_counter()
        logs = build.build_all()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "built": sorted(logs),
              "ptxas": ptxas_summary(logs)})

    queries_np, ref_np, planted = make_data(np, cfg, args.seed)
    q_raw = torch.from_numpy(queries_np).to(dev)
    r_raw = torch.from_numpy(ref_np).to(dev)

    # ------------------------------------------------ 2. K2 parity
    k2 = {}
    for label, x in (("queries", q_raw), ("reference", r_raw[None])):
        got = normalizer.normalize(x.contiguous())
        want = normalizer.normalize_plain(x)
        sync()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, atol=1e-5, rtol=1e-5))
        k2[label] = {"shape": list(x.shape), "max_abs_err": err, "ok": ok}
        require(ok, f"K2 {label}: max abs err {err} over atol=rtol=1e-5")
    emit({"phase": "k2_parity", "tolerance": "atol=rtol=1e-5", **k2})

    # ------------------------------------------------ 3. K1/K3/K4 parity
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
                for window in (False, True):
                    layout2 = wavefront.prepare_reference(r, 2)
                    want = wavefront.wavefront_plain(
                        q, layout2, n=n, w=2, spec=spec,
                        with_window=window)
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
                "wavefront": dict(wavefront.counter.by_variant)}
    require(not cuda or (launches["normalizer"] == 4
                         and launches["wavefront"] == {"K1": 1, "K3": 1}),
            f"main path launches {launches}: want 4 normalizer (queries "
            f"and reference, per call), K1 once and K3 once")
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
    k4_ms = timer(lambda: wavefront.wavefront(qn, layout, n=n, w=w,
                                              spec=band_spec), 20)
    width_ms = {}
    for ww in wavefront.WIDTHS:
        lay = wavefront.prepare_reference(aligner.reference, ww)
        width_ms[ww] = timer(lambda: wavefront.wavefront(
            qn, lay, n=n, w=ww, spec=spec), reps)
    best_w = min(width_ms, key=width_ms.get)
    qc = q_raw.contiguous()
    rc = r_raw[None].contiguous()
    k2_q_ms = timer(lambda: normalizer.normalize(qc), 20)
    k2_r_ms = timer(lambda: normalizer.normalize(rc), 20)
    k2_plain_ms = timer(lambda: normalizer.normalize_plain(qc), 20)
    k2_lib_ms = timer(lambda: torch.nn.functional.layer_norm(
        qc, (qc.shape[-1],), eps=1e-12), 20)

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
    k2_bound, k2_by = bound(2 * qc.numel() * 4,
                            K2_OPS_PER_ELEMENT * qc.numel())
    emit({"phase": "times", "clock": "cuda events" if cuda
          else "host clock (cpu rehearsal, not a device number)",
          "nvidia_smi": smi, "k1_ms": k1_ms, "k3_ms": k3_ms,
          "k4_ms": k4_ms, "k4_band": BAND,
          "k1_ms_by_width": width_ms, "best_width": best_w,
          "k1_plain_ms": plain_k1_ms, "k3_plain_ms": plain_k3_ms,
          "k4_plain_ms": plain_k4_ms,
          "k2_queries_ms": k2_q_ms, "k2_reference_ms": k2_r_ms,
          "k2_plain_ms": k2_plain_ms, "k2_layer_norm_ms": k2_lib_ms,
          "aligner_warm_call_ms": aligner_ms,
          "k1_bound_ms": k1_bound, "k3_bound_ms": k3_bound,
          "k4_bound_ms": k4_bound, "k2_bound_ms": k2_bound,
          "cells": cells, "k4_cells_in_band": k4_cells,
          "k4_cells_visited": B * m * k4_chunks * wavefront.chunk_cols(w),
          "sm_clock_mhz_idle": clock_idle,
          "sm_clock_mhz_under_load": clock_now, "sm_clock_max_mhz": clock_max,
          "lane_ops_per_s": lane_ops_per_s})

    # ------------------------------------------------ 6. kernels line
    cu = "src/repro_torch/kernels/csrc/"
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
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": plain_k4_ms,
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None},
        {"name": "normalizer_K2", "route": "cuda",
         "source": cu + "normalizer.cu",
         "replaces": "src/repro/kernels/normalizer.py:48",
         "launches": launches["normalizer"],
         "parity": "within atol=rtol=1e-5 of the plain version",
         "max_abs_err": k2["queries"]["max_abs_err"], "ms": k2_q_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms},
    ]})
    if not cuda:
        return 0
    require(launches["normalizer"] > 0 and launches["wavefront"]
            and band_launches["wavefront"],
            "a kernel of the main path was never launched")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
