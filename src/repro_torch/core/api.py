"""Public sDTW API of the port — one front door.

The paper's flow (§5): normalize the reference, normalize the batch of
queries, run the batched sweep::

    res = repro_torch.sdtw(queries, reference, outputs=("cost", "end"))
    res.cost, res.end                       # requested fields
    res.start is None                       # unrequested -> None

Counterpart of ``repro.core.api.sdtw``.  The call runs on the CUDA card
unless ``device="cpu"`` is passed; with no card and no ``device="cpu"``
it raises instead of running on the CPU.  On the card the registry puts
the ``kernel`` backend first: both normalizations go through the K2
kernel and the sweep through the K1/K3/K4 wavefront kernel, K5 for a
soft-min spec, or K7 for a recurrence family (``family="twed"`` /
``"erp"`` / ``"local"``, hard- or soft-min).  Under soft-min the returned cost is differentiable with
``torch.autograd`` with respect to the queries and the reference
(through K6 and the normalizer's backward on the kernel backend), and
``outputs=("soft_alignment",)`` returns the expected alignment E.
``outputs=("path",)`` (hard-min sdtw) returns each query's warping path,
recovered on the host (``align.traceback``) inside the window the K3
sweep found.  ``segment_width="auto"`` asks ``repro_torch.tune`` for the
measured fastest plan of the workload on this device.
"""

from __future__ import annotations

from repro_torch.align.soft import expected_alignment_from
from repro_torch.backends import registry
from repro_torch.core.device import as_f32, resolve_device
from repro_torch.core.normalize import normalize_batch
from repro_torch.core.result import (DEFAULT_OUTPUTS, SDTWResult,
                                     normalize_outputs, sweep_outputs)
from repro_torch.core.spec import DPSpec, resolve_spec, validate_batch_inputs
from repro_torch.kernels.backward import soft_alignment_fused
from repro_torch.kernels.ops import (DEFAULT_SEGMENT_WIDTH,
                                     validate_segment_width)


def derive_outputs(res: SDTWResult, req: frozenset, queries, reference,
                   spec: DPSpec) -> SDTWResult:
    """Fill ``path`` from already-normalized operands and restrict the
    result to ``req``.

    The sweep-level fields (cost/end/start) must already be on ``res``
    (one sweep, ``start`` included for a path request); each query's
    path is recovered by the Hirschberg traceback pinned to its window,
    in float64 on the host.  A ``NO_WINDOW`` start means no in-band
    alignment exists (a band blocked the whole bottom row): no path
    either, ``None`` in its place."""
    if "path" in req:
        from repro_torch.align.traceback import host_f64, warping_path
        q64, r64 = host_f64(queries), host_f64(reference)
        res = res.replace(path=[
            None if s < 0 else
            warping_path(q, r64, spec=spec, normalize=False, window=(s, e))
            for q, s, e in zip(q64, res.start.tolist(), res.end.tolist())])
    return res.restrict(req)


def execute(impl: registry.Backend, spec: DPSpec, queries, reference,
            req: frozenset, segment_width: int, *,
            layouts=None) -> SDTWResult:
    """Run one resolved request on already-normalized operands.

    ``soft_alignment`` on the kernel backend is one fused K6 pair that
    also gives cost and end; elsewhere E is derived
    above the sweep by differentiating the cost-matrix sweep
    (``align.soft``), and a request for E alone runs no sweep.
    ``layouts``: an ``Aligner``'s cached forward and reverse kernel
    reference layouts, for the kernel backend's soft-min sweeps.  The
    result keeps the sweep's fields too (``start`` for a path request):
    :func:`derive_outputs` fills the path and restricts it to ``req``."""
    keep = req | sweep_outputs(req)
    if "soft_alignment" in req and impl.name == "kernel":
        cost, end, E = soft_alignment_fused(
            queries, reference, spec=spec, segment_width=segment_width,
            layouts=layouts)
        return SDTWResult(cost=cost, end=end,
                          soft_alignment=E).restrict(keep)
    res = SDTWResult()
    if req - {"soft_alignment"}:
        res = impl.execute(spec, registry.ExecutionPlan(
            queries=queries, reference=reference,
            segment_width=segment_width, outputs=sweep_outputs(req),
            layouts=layouts))
    if "soft_alignment" in req:
        res = res.replace(soft_alignment=expected_alignment_from(
            queries, reference, spec))
    return res.restrict(keep)


def check_width(segment_width) -> int | str:
    """A kernel width, or ``"auto"``; any other string raises."""
    if isinstance(segment_width, str):
        if segment_width != "auto":
            raise ValueError(f"segment_width must be an int >= 1 or "
                             f"'auto', got {segment_width!r}")
        return segment_width
    return validate_segment_width(segment_width)


def auto_width(impl: registry.Backend, spec: DPSpec, req: frozenset,
               reference, workload: tuple, *, pinned: bool,
               device) -> tuple[int, registry.Backend]:
    """Resolve ``segment_width="auto"`` through ``repro_torch.tune``.

    Returns ``(width, backend)``: the tuned width, plus (when the caller
    did NOT pin a backend) the measured winner between kernel and engine
    — a cold call pays the one-time tuning trials, a warm cache answers
    with zero measurements.  A pinned non-kernel backend ignores width
    anyway, so "auto" resolves to the default with zero trials; a
    verdict never overrides capability checks (the swap only happens
    when the winner can serve the request at this query length).
    """
    if not (req - {"soft_alignment"}):      # no backend sweep at all
        return DEFAULT_SEGMENT_WIDTH, impl
    if pinned and impl.name != "kernel":
        return DEFAULT_SEGMENT_WIDTH, impl
    if not pinned and impl.name not in ("kernel", "engine"):
        return DEFAULT_SEGMENT_WIDTH, impl
    from repro_torch import tune
    m, _, batch = workload
    res = tune.autotune(reference, m=m, batch=batch, spec=spec,
                        outputs=sweep_outputs(req),
                        backends=("kernel",) if pinned else None,
                        device=device)
    if (not pinned and res.backend != impl.name
            and (res.from_cache or res.trials > 0)
            and res.backend in registry.capable(spec, outputs=req,
                                                device=device, m=m)):
        impl = registry.get(res.backend)
    return res.segment_width, impl


def sdtw(queries, reference, *,
         outputs=DEFAULT_OUTPUTS,
         normalize: bool = True,
         backend: str | None = None,
         spec: DPSpec | None = None,
         distance: str | None = None,
         reduction: str | None = None,
         gamma: float | None = None,
         band: int | None = None,
         family: str | None = None,
         nu: float | None = None,
         lam: float | None = None,
         gap: float | None = None,
         gap_penalty: float | None = None,
         match_reward: float | None = None,
         segment_width: int | str = 8,
         device=None) -> SDTWResult:
    """Align a batch of queries against one reference.

    queries: (B, M); reference: (N,) — numpy arrays or tensors.  Returns
    an :class:`SDTWResult` with exactly the requested ``outputs``:
    ``cost`` (B,) float32, ``end`` (B,) int32, ``start`` (B,) int32
    (hard-min), ``path`` a list of B (P, 2) int64 numpy arrays
    (hard-min sdtw; ``None`` for a query the band blocks),
    ``soft_alignment`` (B, M, N) float32 (soft-min).
    ``spec`` carries the recurrence; ``distance`` / ``reduction`` /
    ``gamma`` / ``band`` / ``family`` and the family parameters ``nu`` /
    ``lam`` (twed), ``gap`` (erp), ``gap_penalty`` / ``match_reward``
    (local) override its fields.
    ``backend=None`` picks the first capable backend for the device and
    the query length (on the card the kernel, or the engine for queries
    longer than the kernel can launch); a named backend runs every
    length it can or raises; ``backend="soft"`` is the engine under
    soft-min.
    ``segment_width`` is the kernel's reference cells per lane, one of
    ``repro_torch.kernels.ops.DEFAULT_WIDTH_CANDIDATES``, or ``"auto"``:
    the measured fastest plan for this (machine and device, spec,
    shapes, outputs) workload from ``repro_torch.tune`` — tuned once,
    then answered from the persistent cache
    (``REPRO_TORCH_TUNE_CACHE``); results are bit-identical to a pinned
    width under hard-min.
    """
    dev = resolve_device(device)
    width = check_width(segment_width)
    resolved = resolve_spec(spec, distance=distance, reduction=reduction,
                            gamma=gamma, band=band, family=family, nu=nu,
                            lam=lam, gap=gap, gap_penalty=gap_penalty,
                            match_reward=match_reward)
    req = normalize_outputs(outputs)
    q = as_f32(queries, dev)
    r = as_f32(reference, dev)
    validate_batch_inputs(q, r)
    workload = (int(q.shape[1]), int(r.shape[0]), int(q.shape[0]))
    if backend is None:
        impl = registry.select(resolved, outputs=req, device=dev,
                               workload=workload)
    else:
        name, resolved = registry.expand(backend, resolved)
        impl = registry.resolve(name, resolved, outputs=req, device=dev)
    if width == "auto":
        width, impl = auto_width(impl, resolved, req, r, workload,
                                 pinned=backend is not None, device=dev)
    if normalize:
        q = normalize_batch(q)
        r = normalize_batch(r)
    return derive_outputs(execute(impl, resolved, q, r, req, width), req,
                          q, r, resolved)
