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
kernel and the sweep through the K1/K3/K4 wavefront kernel.
"""

from __future__ import annotations

from repro_torch.backends import registry
from repro_torch.core.device import as_f32, resolve_device
from repro_torch.core.normalize import normalize_batch
from repro_torch.core.result import (DEFAULT_OUTPUTS, SDTWResult,
                                     normalize_outputs, sweep_outputs)
from repro_torch.core.spec import (DPSpec, not_ported, resolve_spec,
                                   validate_batch_inputs)
from repro_torch.kernels.ops import validate_segment_width


def check_ported_outputs(req: frozenset) -> None:
    """Reject the outputs this slice does not serve yet."""
    if "path" in req:
        raise not_ported("output 'path'", "slice 3")
    if "soft_alignment" in req:
        raise not_ported("output 'soft_alignment'", "slice 2")


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
         segment_width: int = 8,
         device=None) -> SDTWResult:
    """Align a batch of queries against one reference.

    queries: (B, M); reference: (N,) — numpy arrays or tensors.  Returns
    an :class:`SDTWResult` with exactly the requested ``outputs``:
    ``cost`` (B,) float32, ``end`` (B,) int32, ``start`` (B,) int32.
    ``spec`` carries the recurrence; ``distance`` / ``reduction`` /
    ``gamma`` / ``band`` / ``family`` override its fields.
    ``backend=None`` picks the first capable backend for the device.
    ``segment_width`` is the kernel's reference cells per lane, one of
    ``repro_torch.kernels.ops.DEFAULT_WIDTH_CANDIDATES``.
    """
    dev = resolve_device(device)
    width = check_width(segment_width)
    resolved = resolve_spec(spec, distance=distance, reduction=reduction,
                            gamma=gamma, band=band, family=family)
    req = normalize_outputs(outputs)
    check_ported_outputs(req)
    q = as_f32(queries, dev)
    r = as_f32(reference, dev)
    validate_batch_inputs(q, r)
    if backend is None:
        impl = registry.select(resolved, outputs=req, device=dev)
    else:
        impl = registry.resolve(backend, resolved, outputs=req, device=dev)
    if normalize:
        q = normalize_batch(q)
        r = normalize_batch(r)
    plan = registry.ExecutionPlan(queries=q, reference=r,
                                  segment_width=width,
                                  outputs=sweep_outputs(req))
    return impl.execute(resolved, plan).restrict(req)
