#!/usr/bin/env python3
"""Time the multi-warp wavefront kernels' design choices on one CUDA card.

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
K7 (``csrc/family_wavefront.cu``, twed / erp / local at chip_smoke's
parameters, gamma 0.7 under soft-min), hard-min and soft-min, at the
same workload:
  * 1, 2, 4 and 8 warps per CTA at width 8, and 4 and 8 warps at every
    other width, with the CTAs resident per SM; every output bit-equal
    (hard) or within atol = rtol = 1e-4 (soft, ends equal) to the
    default geometry's, after holding the build to the plain version on
    1 to 2P+1 chunks;
  * the steady loop at width 8 from the SASS: its instructions a step
    (and, soft, its MUFU operations a step);
  * soft-min only: the MUFU ``ex2.approx`` / ``lg2.approx`` soft-min
    (as built) against CUDA's full-accuracy ``exp2f`` / ``log2f``
    (``-DREPRO_EXACT_SOFTMIN``): both held to the plain version on 1 to
    2P+1 chunks, then timed in turns (as built, exact, exact, as built),
    and their PAPER costs compared, the exact build's steady loop
    beside.
The soft-min sDTW sweeps K5 / K6 (``csrc/wavefront.cu`` built with
``-DREPRO_SOFT``, gamma 1, the PAPER soft path's), at the same workload:
  * K5 at 1, 2, 4 and 8 warps per CTA at width 8, and at 4 and 8 warps
    at every other width, with the CTAs resident per SM; every output
    within atol = rtol = 1e-4 of the default geometry's, ends equal; the
    K6 pair at 1 and 8 warps;
  * the MUFU soft-min (as built) against ``-DREPRO_EXACT_SOFTMIN``: K5
    and the K6 pair held to their plain versions on 1 to 2P+1 chunks in
    both builds, then K5 timed in turns and the PAPER costs compared;
  * the steady loop of K5 (forward) and K6-reverse at width 8, both
    builds, from the SASS: instructions and MUFU operations a step.
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
sys.path.insert(0, str(ROOT))

NO_SYNC = ("-DREPRO_STEP_SYNCWARP=0",)
EXACT = ("-DREPRO_EXACT_SOFTMIN",)


def steady_loop(sass: str, entry: str, marker: str = "FMNMX",
                per_step: int | None = None) -> dict:
    """The steady step loop of ``entry``: among its innermost loops (a
    backward branch whose range holds no other loop's branch), the one
    that issues the fewest instructions per ``marker`` opcode (FMNMX for
    the hard-min kernel, MUFU for the soft kernels).  Its length, the steps it
    unrolls (``per_step`` markers a step, 2w FMNMX for the hard-min
    kernel; else one SHFL a step), its instructions and MUFU operations
    a step, and its opcodes."""
    body = next(f for f in re.split(r"\n\s*Function : ", sass)
                if f.split("\n", 1)[0].strip() == entry)
    ins = [(int(a, 16), t.strip()) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    index = {a: i for i, (a, _) in enumerate(ins)}
    spans = []
    for i, (a, t) in enumerate(ins):
        hit = re.search(r"BRA[^0-9]*0x([0-9a-f]+)", t)
        if hit and int(hit.group(1), 16) < a and int(hit.group(1), 16) \
                in index:
            spans.append((index[int(hit.group(1), 16)], i))
    loops = []
    for lo, hi in spans:
        if any(lo < h < hi for _, h in spans):
            continue                        # holds an inner loop
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", x).split()[0].split(".")[0]
            for _, x in ins[lo:hi + 1])
        if ops[marker] >= (per_step or 1) and ops["SHFL"]:
            loops.append((hi + 1 - lo, ops))
    size, ops = min(loops, key=lambda x: x[0] / x[1][marker])
    steps = ops[marker] // per_step if per_step else ops["SHFL"]
    return {"instructions": size, "steps_unrolled": steps,
            "instructions_per_step": size / steps,
            "mufu_per_step": ops["MUFU"] / steps,
            "opcodes": dict(ops.most_common(8))}


def k7(log: list, q, r, series, timed, soft: bool) -> int:
    """The K7 section of one build (see the module docstring).  Returns
    the number of parity mismatches."""
    import torch
    from chip_smoke import FAMILY_GAMMA, FAMILY_PARAMS
    from repro_torch.configs.paper_sdtw import PAPER
    from repro_torch.core.spec import resolve_spec
    from repro_torch.kernels import build, family, ops, wavefront
    exact = build.library("soft_family_wavefront", EXACT) if soft else None
    w, m, n, B = PAPER.segment_width, PAPER.query_len, PAPER.ref_len, \
        PAPER.batch
    P = wavefront.WARPS
    kind = "soft" if soft else "hard"

    def spec_of(fam):
        return resolve_spec(None, family=fam,
                            reduction="softmin" if soft else "hardmin",
                            gamma=FAMILY_GAMMA if soft else None,
                            **FAMILY_PARAMS[fam])

    def same(a, b):
        """Soft: within atol = rtol = 1e-4, ends equal; hard: bit-equal."""
        if not soft:
            return all(torch.equal(x, y) for x, y in zip(a, b))
        return torch.equal(a[1], b[1]) and bool(
            torch.allclose(a[0], b[0], rtol=1e-4, atol=1e-4))

    # the build (and the exact soft-min build) against the plain version,
    # 1 to 2P+1 chunks
    mismatches = cases = 0
    for fam in ("twed", "erp", "local"):
        spec = spec_of(fam)
        for mm in (33, 200):
            for k in (1, P + 1, 2 * P + 1):
                nn = (k - 1) * 64 + 35               # w 2: 64 columns
                qq, rr = series(3, mm), series(nn)
                lay = ops.prepare_reference(rr, 2)
                ex = ops.family_extras(spec, qq, rr, segment_width=2)
                want = family.family_plain(qq, lay, ex, n=nn, w=2,
                                           spec=spec)
                for lib in ((None, exact) if soft else (None,)):
                    got = family.family_cuda(qq, lay, ex, n=nn, w=2,
                                             spec=spec, lib=lib)
                    torch.cuda.synchronize()
                    cases += 1
                    mismatches += not same(got, want)
    emit({"phase": f"{kind}_k7_parity",
          "builds": ["as built", "exact"] if soft else ["as built"],
          "cases": cases, "mismatches": mismatches,
          "rule": "within atol=rtol=1e-4 of the plain version, ends equal"
          if soft else "bit-equal to the plain version"}, log)

    lay = ops.prepare_reference(r, w)
    for fam in ("twed", "erp", "local"):
        spec = spec_of(fam)
        ex = ops.family_extras(spec, q, r, segment_width=w)
        ref = family.family_cuda(q, lay, ex, n=n, w=w, spec=spec)
        for warps in (1, 2, 4, 8):
            out = family.family_cuda(q, lay, ex, n=n, w=w, spec=spec,
                                     warps=warps)
            torch.cuda.synchronize()
            geo = family.family_geometry(m, fam, warps)
            emit({"phase": f"{kind}_k7_warps", "family": fam, "w": w,
                  "warps": warps, "ms": timed(lambda: family.family_cuda(
                      q, lay, ex, n=n, w=w, spec=spec, warps=warps), 2),
                  "ring_rows": geo.ring_rows, "smem_bytes": geo.smem_bytes,
                  "ctas_per_sm": family.family_occupancy(m, w, fam, warps,
                                                         soft=soft),
                  "same_as_default": same(out, ref)}, log)
        for ww in wavefront.WIDTHS:
            if ww == w:
                continue
            wlay = ops.prepare_reference(r, ww)
            wex = ops.family_extras(spec, q, r, segment_width=ww)
            row = {"phase": f"{kind}_k7_width", "family": fam, "w": ww}
            for warps in (4, 8):
                out = family.family_cuda(q, wlay, wex, n=n, w=ww, spec=spec,
                                         warps=warps)
                torch.cuda.synchronize()
                row[f"ms_{warps}_warps"] = timed(
                    lambda: family.family_cuda(q, wlay, wex, n=n, w=ww,
                                               spec=spec, warps=warps), 2)
                row[f"ctas_per_sm_{warps}_warps"] = family.family_occupancy(
                    m, ww, fam, warps, soft=soft)
                row[f"same_as_w{w}_{warps}_warps"] = same(out, ref)
            emit(row, log)
        if not soft:
            continue
        times = {"built": [], "exact": []}
        for which in ("built", "exact", "exact", "built"):
            lib = exact if which == "exact" else None
            times[which].append(timed(lambda: family.family_cuda(
                q, lay, ex, n=n, w=w, spec=spec, lib=lib), 2))
        out = family.family_cuda(q, lay, ex, n=n, w=w, spec=spec, lib=exact)
        torch.cuda.synchronize()
        diff = (out[0] - ref[0]).abs()
        emit({"phase": "soft_k7_softmin", "family": fam, "w": w,
              "built_ms": times["built"], "exact_ms": times["exact"],
              "max_abs_diff": float(diff.max()),
              "max_rel_diff": float((diff / out[0].abs()).max()),
              "ends_equal": int((out[1] == ref[1]).sum()), "queries": B},
             log)

    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    for label, extra in ((("as built", ()), ("exact", EXACT)) if soft
                         else (("as built", ()),)):
        lib_path = build._target(family.library_name(soft), extra)[0]
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              check=True).stdout
        for code, fam in enumerate(("twed", "erp", "local")):
            entry = next(
                e for e in re.findall(r"Function : (\S+)", sass)
                if f"family_kernelILi8ELi{code}ELb0ELb0E" in e)
            emit({"phase": f"{kind}_k7_sass", "build": label,
                  "family": fam, "w": 8,
                  **steady_loop(sass, entry, "MUFU" if soft else "FMNMX")},
                 log)
    return mismatches


def soft_k56(log: list, q, r, series, timed) -> int:
    """The K5/K6 section (see the module docstring).  Returns the number
    of parity mismatches."""
    import torch
    from repro_torch.configs.paper_sdtw import PAPER
    from repro_torch.core.spec import DPSpec
    from repro_torch.kernels import build, ops, wavefront
    exact = build.library("soft_wavefront", EXACT)
    w, m, n, B = PAPER.segment_width, PAPER.query_len, PAPER.ref_len, \
        PAPER.batch
    P = wavefront.WARPS
    spec = DPSpec(reduction="softmin", gamma=1.0)

    def close(a, b):
        return torch.equal(a[1], b[1]) and bool(
            torch.allclose(a[0], b[0], rtol=1e-4, atol=1e-4))

    # both soft-min builds against the plain versions, 1 to 2P+1 chunks
    mismatches = cases = 0
    for mm in (33, 200):
        for k in (1, P + 1, 2 * P + 1):
            nn = (k - 1) * 64 + 35               # w 2: 64 columns
            qq, rr = series(3, mm), series(nn)
            lay = ops.prepare_reference(rr, 2)
            rlay = ops.prepare_reference_reverse(rr, 2)
            qf = torch.flip(qq, (1,)).contiguous()
            want = [wavefront.soft_plain(qq, lay, n=nn, w=2, spec=spec),
                    wavefront.checkpoint_plain(qq, lay, n=nn, w=2,
                                               spec=spec),
                    wavefront.checkpoint_plain(qf, rlay, n=nn, w=2,
                                               spec=spec, reverse=True)]
            for lib in (None, exact):
                got = [wavefront.soft_cuda(qq, lay, n=nn, w=2, spec=spec,
                                           lib=lib),
                       wavefront.soft_cuda(qq, lay, n=nn, w=2, spec=spec,
                                           checkpoint=True, lib=lib),
                       wavefront.soft_cuda(qf, rlay, n=nn, w=2, spec=spec,
                                           reverse=True, lib=lib)]
                torch.cuda.synchronize()
                for i, (a, b) in enumerate(zip(got, want)):
                    cases += 1
                    ok = bool(torch.allclose(a[0], b[0], rtol=1e-4,
                                             atol=1e-4))
                    if i < 2:
                        ok = ok and torch.equal(a[1], b[1])
                    if i:
                        ok = ok and bool(torch.allclose(
                            a[2], b[2], rtol=1e-4, atol=1e-4))
                    mismatches += not ok
    emit({"phase": "k56_parity", "builds": ["as built", "exact"],
          "cases": cases, "mismatches": mismatches,
          "rule": "within atol=rtol=1e-4 of the plain version (cost and "
                  "strips), ends equal"}, log)

    lay = ops.prepare_reference(r, w)
    rlay = ops.prepare_reference_reverse(r, w)
    qf = torch.flip(q, (1,)).contiguous()
    ref = wavefront.soft_cuda(q, lay, n=n, w=w, spec=spec)
    for warps in (1, 2, 4, 8):
        out = wavefront.soft_cuda(q, lay, n=n, w=w, spec=spec, warps=warps)
        torch.cuda.synchronize()
        geo = wavefront.soft_ring_geometry(m, warps)
        row = {"phase": "k56_warps", "w": w, "warps": warps,
               "k5_ms": timed(lambda: wavefront.soft_cuda(
                   q, lay, n=n, w=w, spec=spec, warps=warps), 2),
               "ring_rows": geo.ring_rows, "smem_bytes": geo.smem_bytes,
               "ctas_per_sm": wavefront.soft_occupancy(m, w, warps=warps),
               "close_to_default": close(out, ref)}
        if warps in (1, P):
            row["k6f_ms"] = timed(lambda: wavefront.soft_cuda(
                q, lay, n=n, w=w, spec=spec, checkpoint=True, warps=warps),
                2)
            row["k6r_ms"] = timed(lambda: wavefront.soft_cuda(
                qf, rlay, n=n, w=w, spec=spec, reverse=True, warps=warps),
                2)
        emit(row, log)
    for ww in wavefront.WIDTHS:
        if ww == w:
            continue
        wlay = ops.prepare_reference(r, ww)
        row = {"phase": "k56_width", "w": ww}
        for warps in (4, 8):
            out = wavefront.soft_cuda(q, wlay, n=n, w=ww, spec=spec,
                                      warps=warps)
            torch.cuda.synchronize()
            row[f"k5_ms_{warps}_warps"] = timed(
                lambda: wavefront.soft_cuda(q, wlay, n=n, w=ww, spec=spec,
                                            warps=warps), 2)
            row[f"ctas_per_sm_{warps}_warps"] = wavefront.soft_occupancy(
                m, ww, warps=warps)
            row[f"close_to_w{w}_{warps}_warps"] = close(out, ref)
        emit(row, log)
    times = {"built": [], "exact": []}
    for which in ("built", "exact", "exact", "built"):
        lib = exact if which == "exact" else None
        times[which].append(timed(lambda: wavefront.soft_cuda(
            q, lay, n=n, w=w, spec=spec, lib=lib), 2))
    out = wavefront.soft_cuda(q, lay, n=n, w=w, spec=spec, lib=exact)
    torch.cuda.synchronize()
    diff = (out[0] - ref[0]).abs()
    emit({"phase": "k56_softmin", "w": w, "built_ms": times["built"],
          "exact_ms": times["exact"], "max_abs_diff": float(diff.max()),
          "max_rel_diff": float((diff / out[0].abs()).max()),
          "ends_equal": int((out[1] == ref[1]).sum()), "queries": B}, log)

    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    for label, extra in (("as built", ()), ("exact", EXACT)):
        lib_path = build._target("soft_wavefront", extra)[0]
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              check=True).stdout
        for name, rev in (("K5", 0), ("K6-reverse", 1)):
            entry = next(
                e for e in re.findall(r"Function : (\S+)", sass)
                if f"soft_wavefront_kernelILi8ELb{rev}ELb0ELb0E" in e)
            emit({"phase": "k56_sass", "build": label, "kernel": name,
                  "w": 8, **steady_loop(sass, entry, "MUFU")}, log)
    return mismatches


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
    # the two variant builds, side by side
    build._compile({
        "nosync": build._target("wavefront", NO_SYNC),
        "exact": build._target("soft_family_wavefront", EXACT),
        "exact_k56": build._target("soft_wavefront", EXACT)})
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
              **steady_loop(sass, entry, "FMNMX", 16)}, log)

    soft_mismatches = k7(log, q, r, series, timed, soft=False)
    soft_mismatches += k7(log, q, r, series, timed, soft=True)
    soft_mismatches += soft_k56(log, q, r, series, timed)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wavefront_variants.json").write_text(json.dumps(log,
                                                                indent=1))
    return 0 if mismatches == 0 and soft_mismatches == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
