#!/usr/bin/env python3
"""Time the hard-min wavefront kernel's design choices on one CUDA card.

    python3 scripts/wavefront_variants.py [--seed 0] [--reps 3]

At the paper's workload (512 queries x 2,000 samples against 100,000,
segment width 8), with CUDA events, warm:
  * K1 and K3 at 1, 2, 4 and 8 warps per CTA, with the CTAs each
    geometry keeps resident per SM, and K1 at 4 and 8 warps at the other
    widths; every output bit-equal to the default geometry's;
  * the kernel built without its per-step ``__syncwarp()``
    (``-DREPRO_STEP_SYNCWARP=0``) against the kernel as built, in turns
    (built, without, without, built), after holding the variant
    bit-equal to the plain version on references of 1 to 2P+1 chunks at
    every width, with and without the start lane.
And from the SASS of the built library (``cuobjdump -sass``), the
steady step loop of K1 and K3 at width 8: its instructions, the steps it
unrolls (two mins a cell) and the instructions a step.
Prints one JSON line per measurement and the card's ``nvidia-smi`` name
and power limit; writes the lot to ``chiprun_out/wavefront_variants.json``.
Needs a card: exits 1 without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

NO_SYNC = ("-DREPRO_STEP_SYNCWARP=0",)


def steady_loop(sass: str, entry: str, w: int) -> dict:
    """The loop of ``entry`` that issues the fewest instructions per
    step (a step of w cells issues 2w FMNMX), the steady step loop: its
    length, the steps it unrolls, its instructions a step and opcodes."""
    body = next(f for f in re.split(r"\n\s*Function : ", sass)
                if f.split("\n", 1)[0].strip() == entry)
    ins = [(int(a, 16), t.strip()) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    index = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, t) in enumerate(ins):
        hit = re.search(r"BRA[^0-9]*0x([0-9a-f]+)", t)
        if hit and int(hit.group(1), 16) < a and int(hit.group(1), 16) \
                in index:
            loop = ins[index[int(hit.group(1), 16)]:i + 1]
            ops = collections.Counter(
                re.sub(r"^@!?U?P\w+\s+", "", x).split()[0].split(".")[0]
                for _, x in loop)
            if ops["FMNMX"] >= 2 * w:
                loops.append((len(loop), ops))
    size, ops = min(loops, key=lambda x: x[0] / x[1]["FMNMX"])
    steps = ops["FMNMX"] // (2 * w)
    return {"instructions": size, "steps_unrolled": steps,
            "instructions_per_step": size / steps,
            "opcodes": dict(ops.most_common(8))}


def emit(obj, log: list) -> None:
    log.append(obj)
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("wavefront_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs.paper_sdtw import PAPER
    from repro_torch.core.normalize import normalize_batch
    from repro_torch.core.spec import DPSpec
    from repro_torch.kernels import build, wavefront

    log: list = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"nvidia_smi": smi}, log)
    nosync = build.library("wavefront", NO_SYNC)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def series(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return normalize_batch(x.to(dev))

    def timed(fn, reps=args.reps):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    # the variant without the per-step barrier, against the plain version
    mismatches = cases = 0
    for w in wavefront.WIDTHS:
        W = wavefront.chunk_cols(w)
        P = wavefront.WARPS
        for k in (1, P - 1, P, P + 1, 2 * P + 1):
            n = (k - 1) * W + W // 2 + 3
            q, r = series(9, 200), series(n)
            lay = wavefront.prepare_reference(r, w)
            for window in (False, True):
                for band in (None, 64):
                    spec = DPSpec(band=band)
                    want = wavefront.wavefront_plain(q, lay, n=n, w=w,
                                                     spec=spec,
                                                     with_window=window)
                    got = wavefront.wavefront_cuda(q, lay, n=n, w=w,
                                                   spec=spec,
                                                   with_window=window,
                                                   lib=nosync)
                    torch.cuda.synchronize()
                    cases += 1
                    mismatches += not all(torch.equal(a, b)
                                          for a, b in zip(got, want))
    emit({"phase": "nosync_parity", "cases": cases,
          "mismatches": mismatches,
          "rule": "bit-equal to the plain version"}, log)

    cfg = PAPER
    w, m, n, B = cfg.segment_width, cfg.query_len, cfg.ref_len, cfg.batch
    q, r = series(B, m), series(n)
    lay = wavefront.prepare_reference(r, w)
    spec = DPSpec()
    ref = {win: wavefront.wavefront_cuda(q, lay, n=n, w=w, spec=spec,
                                         with_window=win)
           for win in (False, True)}
    for ww in wavefront.WIDTHS:
        if ww == w:
            continue
        wlay = wavefront.prepare_reference(r, ww)
        row = {"phase": "warps_by_width", "w": ww}
        want = wavefront.wavefront_cuda(q, wlay, n=n, w=ww, spec=spec)
        for warps in (4, 8):
            out = wavefront.wavefront_cuda(q, wlay, n=n, w=ww, spec=spec,
                                           warps=warps)
            torch.cuda.synchronize()
            row[f"k1_ms_{warps}_warps"] = timed(
                lambda: wavefront.wavefront_cuda(q, wlay, n=n, w=ww,
                                                 spec=spec, warps=warps))
            row[f"k1_ctas_per_sm_{warps}_warps"] = wavefront.hard_occupancy(
                m, ww, warps=warps)
            row[f"equal_{warps}_warps"] = all(
                torch.equal(a, b) for a, b in zip(out, want))
        emit(row, log)
    for warps in (1, 2, 4, 8):
        row = {"phase": "warps", "warps": warps, "w": w}
        for win, name in ((False, "k1"), (True, "k3")):
            out = wavefront.wavefront_cuda(q, lay, n=n, w=w, spec=spec,
                                           with_window=win, warps=warps)
            torch.cuda.synchronize()
            geo = wavefront.hard_geometry(m, win, warps)
            row[f"{name}_ms"] = timed(lambda: wavefront.wavefront_cuda(
                q, lay, n=n, w=w, spec=spec, with_window=win, warps=warps))
            row[f"{name}_equal_to_default"] = all(
                torch.equal(a, b) for a, b in zip(out, ref[win]))
            row[f"{name}_ring_rows"] = geo.ring_rows
            row[f"{name}_smem_bytes"] = geo.smem_bytes
            row[f"{name}_ctas_per_sm"] = wavefront.hard_occupancy(
                m, w, with_window=win, warps=warps)
        emit(row, log)

    for win, name in ((False, "K1"), (True, "K3")):
        times = {"built": [], "without": []}
        for which in ("built", "without", "without", "built"):
            lib = nosync if which == "without" else None
            times[which].append(timed(lambda: wavefront.wavefront_cuda(
                q, lay, n=n, w=w, spec=spec, with_window=win, lib=lib)))
        out = wavefront.wavefront_cuda(q, lay, n=n, w=w, spec=spec,
                                       with_window=win, lib=nosync)
        torch.cuda.synchronize()
        emit({"phase": "step_syncwarp", "kernel": name, "w": w,
              "with_ms": times["built"], "without_ms": times["without"],
              "without_equal_to_with": all(
                  torch.equal(a, b) for a, b in zip(out, ref[win]))}, log)

    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    lib_path = build._target("wavefront")[0]
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    for name, window in (("K1", 0), ("K3", 1)):
        entry = next(e for e in re.findall(r"Function : (\S+)", sass)
                     if f"wavefront_kernelILi8ELb{window}ELb0ELb0E" in e)
        emit({"phase": "sass", "kernel": name, "w": 8,
              **steady_loop(sass, entry, 8)}, log)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wavefront_variants.json").write_text(json.dumps(log,
                                                                indent=1))
    return 0 if mismatches == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
