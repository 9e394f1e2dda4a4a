"""Budgeted, measured autotuner for sDTW dispatch plans.

Counterpart of ``repro.tune.tuner``.  The paper's Fig. 3 shows
throughput peaking at a workload-dependent per-lane segment width; the
knob only changes the kernel's sweep *schedule*, never the recurrence,
so any width is safe to dispatch and the only question is which is
fastest HERE — this device, this DPSpec, these shapes.

:func:`autotune` answers it empirically: it synthesizes a seeded query
batch of the workload's bucketed shape, measures the engine baseline
plus a hill-climb over :func:`repro_torch.kernels.ops.width_candidates`
(starting at the default width 8, expanding to neighbors while they
keep winning), and records the argmin as a verdict in the
:class:`~repro_torch.tune.cache.TuningCache` of the device the trials
ran on.  Every measurement ticks the ``tune.trials`` counter and runs
under a ``tune.search`` tracer span; a warm cache answers with
``tune.cache_hits`` and ZERO trials.

A cold key additionally consults the cache's OTHER shapes: when a
nearby (m, n, bucket) of the same spec + outputs was already tuned,
its winning width seeds the hill-climb start (``tune.seeded_starts``).
The default width still always gets measured among the kernel
candidates, so the tuned plan can never be slower than
``segment_width=8`` on the measurements it was chosen by.

One deliberate difference from ``repro``: a trial that raises is not
logged and dropped, it propagates — a kernel that fails to build or to
launch must never hide behind an engine verdict.  No width fails for
the shape alone: the kernel's longest query does not depend on the
width (``kernels/wavefront.py::longest_query``), and a query longer
than that drops the kernel from the candidates before any trial.

Timing: the default timer takes the minimum over ``budget.runs`` of
``perf_counter`` around one call, with ``torch.cuda.synchronize`` before
and after it on a CUDA device (a launch returns before the kernel ends).
Determinism for tests: pass ``timer=lambda label, make_fn: seconds`` to
replace wall-clock measurement with a fake — same fake timings, same
winner, no device in the loop.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.device import as_f32, resolve_device
from repro_torch.core.result import normalize_outputs, sweep_outputs
from repro_torch.core.spec import DEFAULT_SPEC, DPSpec
from repro_torch.kernels import ops
from repro_torch.tune.cache import (TuningCache, default_cache,
                                    machine_key, workload_key)
from repro_torch.obs.bench import machine_fingerprint

_TUNABLE = ("kernel", "engine")   # backends the tuner knows how to time
BUCKET_BASE = 8
#   The smallest batch bucket: the JAX kernel's SUBLANES, kept so that
#   both packages key a workload alike.


@dataclasses.dataclass(frozen=True)
class TuneBudget:
    """How much device time a cold tune may spend.

    max_trials:  hard cap on distinct (backend, width) measurements.
    warmup:      untimed executions per trial (build + cache warm).
    runs:        timed executions per trial; the trial's time is their
                 minimum (robust to scheduler noise).
    max_seconds: optional wall-clock cap for the whole search; the
                 search stops starting new trials once exceeded (the
                 measurements already taken still pick the winner).
    """

    max_trials: int = 32
    warmup: int = 1
    runs: int = 3
    max_seconds: float | None = None

    def __post_init__(self):
        if self.max_trials < 1:
            raise ValueError("max_trials must be >= 1")
        if self.warmup < 0 or self.runs < 1:
            raise ValueError("warmup must be >= 0 and runs >= 1")


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """What a tune decided, and the evidence.

    backend/segment_width: the winning dispatch plan.
    key:        the cache key the verdict lives under.
    from_cache: True when no measurement happened (warm cache).
    trials:     measurements performed by THIS call (0 when warm).
    best_ms:    winner's measured milliseconds (None when the verdict
                carried no timing).
    measured:   label -> milliseconds for every trial this call ran.
    """

    backend: str
    segment_width: int
    key: str
    from_cache: bool
    trials: int
    best_ms: float | None
    measured: Mapping[str, float]

    def verdict(self) -> dict:
        return {"backend": self.backend,
                "segment_width": self.segment_width,
                "best_ms": self.best_ms,
                "trials": self.trials,
                "measured": dict(self.measured),
                "created_unix": time.time()}


def batch_bucket(batch: int, *, max_bucket: int = 4096) -> int:
    """The 8 x 2^k bucket a batch of this size lands in (capped at
    ``max_bucket``) — tuning keys use the bucket so nearby batch sizes
    share a verdict, as ``repro.tune.batch_bucket`` does."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    size = BUCKET_BASE
    while size < batch and size < max_bucket:
        size *= 2
    return size


def _default_timer(budget: TuneBudget, device: torch.device) -> Callable:
    """Wall-clock measurement: build (untimed), warm up, then take the
    min of ``budget.runs`` calls, each between two synchronizes of the
    card (none on the CPU)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timer(label: str, make_fn: Callable[[], Callable]) -> float:
        fn = make_fn()
        for _ in range(budget.warmup):
            fn()
        best = float("inf")
        for _ in range(budget.runs):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    return timer


def _seeded_queries(batch: int, m: int) -> np.ndarray:
    """The synthetic workload every trial times: fixed seed, so two
    tunes of the same key measure the same arithmetic."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((batch, m)).astype(np.float32)


_KEY_SHAPE = re.compile(r"\|m=(\d+)\|n=(\d+)\|b=(\d+)\|out=")


def _seed_width(cache: TuningCache, spec: DPSpec, *, m: int, n: int,
                bucket: int, outputs) -> int | None:
    """Cross-shape seeding: the hill-climb start for a COLD key borrows
    the winning width of the nearest already-tuned shape of the same
    spec + outputs.

    A candidate entry only counts when re-deriving its key through
    :func:`workload_key` from the shape fields reproduces the stored
    key byte-for-byte — that round-trip proves the entry belongs to
    THIS spec (family included) and outputs.  Nearest = smallest L1
    distance over (m, n, bucket); ties break toward the smaller shape
    and then the key string, so seeding is deterministic.
    """
    best = None   # ((distance, m', n', b', key), width)
    for key, verdict in cache.entries().items():
        mt = _KEY_SHAPE.search(key)
        if not mt:
            continue
        mp, np_, bp = (int(g) for g in mt.groups())
        if (mp, np_, bp) == (m, n, bucket):
            continue            # the exact key already missed: stale row
        if workload_key(spec=spec, m=mp, n=np_, batch_bucket=bp,
                        outputs=outputs) != key:
            continue            # other spec/outputs (or a parse alias)
        w = verdict.get("segment_width")
        if isinstance(w, bool) or not isinstance(w, int) or w < 1:
            continue
        rank = (abs(mp - m) + abs(np_ - n) + abs(bp - bucket),
                mp, np_, bp, key)
        if best is None or rank < best[0]:
            best = (rank, w)
    return None if best is None else best[1]


def _candidate_backends(spec: DPSpec, req: frozenset, m: int,
                        backends) -> list[str]:
    """The tunable backends able to run this spec/outputs at query
    length ``m``, preference order preserved; incapable ones drop out
    (the kernel for a query longer than it launches, or for cosine)."""
    from repro_torch.backends import registry
    wanted = _TUNABLE if backends is None else tuple(backends)
    out = []
    for name in wanted:
        if name not in _TUNABLE:
            raise ValueError(f"cannot tune backend {name!r}; tunable: "
                             f"{list(_TUNABLE)}")
        reason = registry.get(name).capabilities.unsupported_reason(
            spec, outputs=req, m=m)
        if reason is None:
            out.append(name)
    return out


def _device_of(reference, device) -> torch.device:
    if device is None and isinstance(reference, torch.Tensor):
        return reference.device
    return resolve_device(device)


def autotune(reference, *, m: int, batch: int,
             spec: DPSpec | None = None,
             outputs=("cost", "end"),
             backends: Sequence[str] | None = None,
             candidates: Sequence[int] | None = None,
             device=None,
             budget: TuneBudget | None = None,
             cache: TuningCache | None = None,
             metrics=None, tracer=None,
             timer: Callable | None = None) -> TuneResult:
    """Pick the fastest (backend, segment_width) plan for a workload.

    reference: (N,) reference the plan will dispatch against (numpy or
               a tensor; its values are used in the trials, its length
               keys the verdict).
    m/batch:   query length and batch size of the workload; the batch
               is bucketed (:func:`batch_bucket`) before keying.
    outputs:   result fields the plan must produce — a window-producing
               plan times differently from a cost-only one, so they
               tune separately.
    backends:  restrict the search (e.g. ``("kernel",)`` when the
               caller already pinned the backend); None = kernel vs
               engine, whichever support the spec.
    device:    where the trials run (default: the reference tensor's
               device, else the card); ``cache`` must be that device's.
    timer:     ``timer(label, make_fn) -> seconds`` override for tests.

    Returns a :class:`TuneResult`; the verdict is persisted in
    ``cache`` (default: :func:`default_cache` of the device) so the
    next process is a pure cache hit.  A trial's exception propagates.
    """
    dev = _device_of(reference, device)
    spec = DEFAULT_SPEC if spec is None else spec
    req = sweep_outputs(normalize_outputs(outputs))
    budget = TuneBudget() if budget is None else budget
    cache = default_cache(dev) if cache is None else cache
    here = machine_key(machine_fingerprint(dev))
    if cache.machine != here:
        raise ValueError(
            f"tuning cache {cache!r} holds verdicts of machine "
            f"{cache.machine!r}; this tune runs on {here!r}")
    metrics = obs.default_registry() if metrics is None else metrics
    tracer = obs.default_tracer() if tracer is None else tracer

    n = int(reference.shape[0])
    bucket = batch_bucket(batch)
    key = cache.key(spec=spec, m=m, n=n, batch_bucket=bucket, outputs=req)

    names = _candidate_backends(spec, req, m, backends)

    hit = cache.get(key)
    if hit is not None and (not names or hit["backend"] in names
                            or hit["backend"] not in _TUNABLE):
        metrics.inc("tune.cache_hits")
        return TuneResult(backend=hit["backend"],
                          segment_width=hit["segment_width"], key=key,
                          from_cache=True, trials=0,
                          best_ms=hit.get("best_ms"),
                          measured=hit.get("measured", {}))

    if not names:
        # nothing tunable supports this spec (e.g. cosine distance):
        # hand back the untuned default rather than failing a dispatch
        return TuneResult(backend="engine", segment_width=
                          ops.DEFAULT_SEGMENT_WIDTH, key=key,
                          from_cache=False, trials=0, best_ms=None,
                          measured={})

    widths = ops.width_candidates(n, candidates)
    queries = _seeded_queries(bucket, m)
    return_window = "start" in req
    timer = _default_timer(budget, dev) if timer is None else timer

    measured: dict[str, float] = {}
    started = time.monotonic()

    def exhausted() -> bool:
        if len(measured) >= budget.max_trials:
            return True
        return (budget.max_seconds is not None
                and time.monotonic() - started > budget.max_seconds)

    def trial(label: str, make_fn: Callable[[], Callable]) -> None:
        if label in measured or exhausted():
            return
        measured[label] = float(timer(label, make_fn))
        metrics.inc("tune.trials")

    def kernel_fn(width: int) -> Callable[[], Callable]:
        def make():
            q = as_f32(queries, dev)
            r = as_f32(reference, dev)

            def fn():
                with torch.no_grad():
                    return ops.sdtw_wavefront(
                        q, r, segment_width=width, spec=spec,
                        return_window=return_window)
            return fn
        return make

    def engine_fn() -> Callable:
        from repro_torch.backends import registry
        plan = registry.ExecutionPlan(queries=as_f32(queries, dev),
                                      reference=as_f32(reference, dev),
                                      outputs=req)
        engine = registry.get("engine")

        def fn():
            with torch.no_grad():
                return engine.execute(spec, plan)
        return fn

    with tracer.span("tune.search", key=key, backends=",".join(names),
                     widths=",".join(map(str, widths))) as sp:
        if "engine" in names:
            trial("engine", engine_fn)
        if "kernel" in names:
            # hill-climb start: the default width, unless a neighboring
            # shape of the same spec+outputs was already tuned — then
            # its winning width seeds the climb (tune.seeded_starts);
            # the default still gets measured, so the tuned plan can
            # never lose to segment_width=8 on its own evidence.  From
            # the start, keep expanding to unmeasured neighbors of the
            # current best until it stops moving or the budget runs out.
            order = list(widths)
            start = (ops.DEFAULT_SEGMENT_WIDTH
                     if ops.DEFAULT_SEGMENT_WIDTH in order
                     else order[len(order) // 2])
            seed = _seed_width(cache, spec, m=m, n=n, bucket=bucket,
                               outputs=req)
            if seed is not None and seed in order:
                metrics.inc("tune.seeded_starts")
                sp.set(seeded_start=seed)
                trial(f"kernel:w{seed}", kernel_fn(seed))
            trial(f"kernel:w{start}", kernel_fn(start))
            while not exhausted():
                kern = {int(lb.split("w", 1)[1]): t
                        for lb, t in measured.items()
                        if lb.startswith("kernel:w")}
                if not kern:
                    break
                best_w = min(kern, key=lambda w: (kern[w], w))
                i = order.index(best_w)
                frontier = [w for w in
                            (order[i - 1] if i > 0 else None,
                             order[i + 1] if i + 1 < len(order) else None)
                            if w is not None and w not in kern]
                if not frontier:
                    break
                for w in frontier:
                    trial(f"kernel:w{w}", kernel_fn(w))

        if not measured:
            # the wall-clock budget ran out before the first trial: fall
            # back to the untuned default so the caller still dispatches
            sp.set(trials=0, winner="default")
            return TuneResult(backend=names[0], segment_width=
                              ops.DEFAULT_SEGMENT_WIDTH, key=key,
                              from_cache=False, trials=0, best_ms=None,
                              measured={})

        win_label = min(measured, key=lambda lb: (measured[lb], lb))
        if win_label.startswith("kernel:w"):
            win_backend = "kernel"
            win_width = int(win_label.split("w", 1)[1])
        else:
            win_backend = "engine"
            kern = {int(lb.split("w", 1)[1]): t for lb, t in
                    measured.items() if lb.startswith("kernel:w")}
            # engine won, but record the best kernel width seen so a
            # later kernel-pinned caller of this key still benefits
            win_width = (min(kern, key=lambda w: (kern[w], w))
                         if kern else ops.DEFAULT_SEGMENT_WIDTH)
        sp.set(trials=len(measured), winner=win_label,
               best_ms=measured[win_label] * 1e3)

    result = TuneResult(backend=win_backend, segment_width=win_width,
                        key=key, from_cache=False, trials=len(measured),
                        best_ms=measured[win_label] * 1e3,
                        measured={lb: t * 1e3
                                  for lb, t in measured.items()})
    cache.put(key, result.verdict())
    return result


def cached_verdict(spec: DPSpec, *, m: int, n: int, batch: int,
                   outputs=None, device=None) -> dict | None:
    """Silent cache lookup for backend auto-selection
    (``registry.select``): the verdict dict when this exact workload
    has been tuned on this machine's ``device``, else None.  Never
    measures, never raises — selection must not get slower or flakier
    because tuning exists."""
    try:
        req = sweep_outputs(normalize_outputs(
            outputs if outputs is not None else ("cost", "end")))
        cache = default_cache(device)
        key = cache.key(spec=spec, m=m, n=n,
                        batch_bucket=batch_bucket(batch), outputs=req)
        return cache.get(key)
    except Exception:
        return None
