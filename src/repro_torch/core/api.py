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
"""

from __future__ import annotations

from repro_torch.align.soft import expected_alignment_from
from repro_torch.backends import registry
from repro_torch.core.device import as_f32, resolve_device
from repro_torch.core.normalize import normalize_batch
from repro_torch.core.result import (DEFAULT_OUTPUTS, SDTWResult,
                                     normalize_outputs, sweep_outputs)
from repro_torch.core.spec import (DPSpec, not_ported, resolve_spec,
                                   validate_batch_inputs)
from repro_torch.kernels.backward import soft_alignment_fused
from repro_torch.kernels.ops import validate_segment_width


def check_ported_outputs(req: frozenset, spec: DPSpec) -> None:
    """Reject the outputs the port does not serve yet.  A family's
    ``path`` is left to the registry, whose reason holds for good (the
    traceback recovers sdtw paths only)."""
    if "path" in req and spec.family == "sdtw":
        raise not_ported("output 'path'", "slice 3")


def execute(impl: registry.Backend, spec: DPSpec, queries, reference,
            req: frozenset, segment_width: int, *,
            layouts=None) -> SDTWResult:
    """Run one resolved request on already-normalized operands.

    ``soft_alignment`` on the kernel backend is one fused K6 pair that
    also gives cost and end; elsewhere E is derived
    above the sweep by differentiating the cost-matrix sweep
    (``align.soft``), and a request for E alone runs no sweep.
    ``layouts``: an ``Aligner``'s cached forward and reverse kernel
    reference layouts, for the kernel backend's soft-min sweeps."""
    if "soft_alignment" in req and impl.name == "kernel":
        cost, end, E = soft_alignment_fused(
            queries, reference, spec=spec, segment_width=segment_width,
            layouts=layouts)
        return SDTWResult(cost=cost, end=end, soft_alignment=E).restrict(req)
    res = SDTWResult()
    if req - {"soft_alignment"}:
        res = impl.execute(spec, registry.ExecutionPlan(
            queries=queries, reference=reference,
            segment_width=segment_width, outputs=sweep_outputs(req),
            layouts=layouts))
    if "soft_alignment" in req:
        res = res.replace(soft_alignment=expected_alignment_from(
            queries, reference, spec))
    return res.restrict(req)


def check_width(segment_width) -> int:
    if isinstance(segment_width, str):
        raise not_ported(f"segment_width={segment_width!r}", "slice 7")
    return validate_segment_width(segment_width)


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
         segment_width: int = 8,
         device=None) -> SDTWResult:
    """Align a batch of queries against one reference.

    queries: (B, M); reference: (N,) — numpy arrays or tensors.  Returns
    an :class:`SDTWResult` with exactly the requested ``outputs``:
    ``cost`` (B,) float32, ``end`` (B,) int32, ``start`` (B,) int32
    (hard-min), ``soft_alignment`` (B, M, N) float32 (soft-min).
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
    ``repro_torch.kernels.ops.DEFAULT_WIDTH_CANDIDATES``.
    """
    dev = resolve_device(device)
    width = check_width(segment_width)
    resolved = resolve_spec(spec, distance=distance, reduction=reduction,
                            gamma=gamma, band=band, family=family, nu=nu,
                            lam=lam, gap=gap, gap_penalty=gap_penalty,
                            match_reward=match_reward)
    req = normalize_outputs(outputs)
    check_ported_outputs(req, resolved)
    q = as_f32(queries, dev)
    r = as_f32(reference, dev)
    validate_batch_inputs(q, r)
    if backend is None:
        impl = registry.select(resolved, outputs=req, device=dev,
                               m=q.shape[1])
    else:
        name, resolved = registry.expand(backend, resolved)
        impl = registry.resolve(name, resolved, outputs=req, device=dev)
    if normalize:
        q = normalize_batch(q)
        r = normalize_batch(r)
    return execute(impl, resolved, q, r, req, width)
