"""Aligner — an sDTW session for one reference.

The paper's §5 session: normalize the reference once, then stream
query batches against it::

    aligner = repro_torch.Aligner(reference, band=128)
    res = aligner(queries)
    res = aligner(queries, outputs=("cost", "start", "end"))

Counterpart of ``repro.core.session.Aligner``.  The reference is
normalized once at construction (one K2 launch on the card); the
kernel's reference layouts (forward, and reverse for the soft-DTW
backward) and a family's reference-derived operands (twed's shifted
reference, erp's gap prefix) are built once per segment width and
cached; each call normalizes its queries (one K2 launch) and runs one
sweep (one wavefront launch: K1/K3/K4, K5 under soft-min, K7 for a
recurrence family, given ``spec=DPSpec(family=...)``).  A soft-min call that autograd
must differentiate, or that asks for ``soft_alignment`` (over the
cached layouts), runs the K6 pair instead.  A session that picked its
backend itself (``backend=None``) runs a batch whose queries are longer
than the kernel can launch on the next capable backend (the engine) for
that call.  PyTorch runs eagerly, so there is no executable cache:
:class:`AlignerStats` counts calls and layout builds only.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.backends import registry
from repro_torch.core.api import check_ported_outputs, check_width, execute
from repro_torch.core.device import as_f32, resolve_device
from repro_torch.core.normalize import normalize_batch
from repro_torch.core.result import (DEFAULT_OUTPUTS, SDTWResult,
                                     from_sweep, normalize_outputs,
                                     sweep_outputs)
from repro_torch.core.spec import (DPSpec, resolve_spec,
                                   validate_batch_inputs)
from repro_torch.kernels import ops


@dataclasses.dataclass
class AlignerStats:
    """Session accounting: ``calls`` counts align() calls that ran a
    sweep, ``layout_builds`` the kernel reference layouts built."""

    calls: int = 0
    layout_builds: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Aligner:
    """A session: one reference, one spec, one backend, many batches.

    Parameters mirror :func:`repro_torch.sdtw`.  ``outputs`` is a hint
    naming the outputs this session will serve, so that auto-selection
    lands on a backend that can fill them; each call re-validates its
    own request.
    """

    def __init__(self, reference, *, spec: DPSpec | None = None,
                 backend: str | None = None,
                 normalize: bool = True,
                 distance: str | None = None,
                 reduction: str | None = None,
                 gamma: float | None = None,
                 band: int | None = None,
                 outputs=None,
                 segment_width: int = 8,
                 device=None):
        self.device = resolve_device(device)
        self.segment_width = check_width(segment_width)
        r = as_f32(reference, self.device)
        if r.ndim != 1:
            raise ValueError(
                f"reference must be 1-D (length,), got {tuple(r.shape)}")
        if r.shape[0] == 0:
            raise ValueError("empty reference (reference.shape[0] == 0)")
        self.spec = resolve_spec(spec, distance=distance,
                                 reduction=reduction, gamma=gamma,
                                 band=band)
        hint = None if outputs is None else normalize_outputs(outputs)
        if hint is not None:
            check_ported_outputs(hint, self.spec)
        # chosen before any query exists: align() re-asks the registry
        # with the query length when the session chose it itself
        self.auto_backend = backend is None
        if backend is None:
            self.backend = registry.select(self.spec, outputs=hint,
                                           device=self.device)
        else:
            name, self.spec = registry.expand(backend, self.spec)
            self.backend = registry.resolve(name, self.spec, outputs=hint,
                                            device=self.device)
        self.normalize = normalize
        self.reference = normalize_batch(r) if normalize else r
        self.length = int(r.shape[0])
        self._layouts: dict = {}
        self.stats = AlignerStats()

    def layout(self, segment_width: int | None = None, *,
               reverse: bool = False):
        """The kernel's reference layout for one width (``reverse``: the
        reverse sweep's), built at most once per session."""
        w = self.segment_width if segment_width is None else \
            check_width(segment_width)
        lay = self._layouts.get((w, reverse))
        if lay is None:
            prep = (ops.prepare_reference_reverse if reverse
                    else ops.prepare_reference)
            lay = self._layouts[(w, reverse)] = prep(
                self.reference.detach(), w)
            self.stats.layout_builds += 1
        return lay

    def family_extras(self, segment_width: int | None = None) -> tuple:
        """The family's reference-derived kernel operands for one width
        (``ops.family_extras_ref``), computed at most once per session."""
        w = self.segment_width if segment_width is None else \
            check_width(segment_width)
        ex = self._layouts.get((w, "family"))
        if ex is None:
            ex = self._layouts[(w, "family")] = ops.family_extras_ref(
                self.spec, self.reference.detach(), segment_width=w)
        return ex

    def align(self, queries, *, outputs=DEFAULT_OUTPUTS) -> SDTWResult:
        """Align one query batch (B, M) against the session's reference."""
        req = normalize_outputs(outputs)
        check_ported_outputs(req, self.spec)
        registry.resolve(self.backend.name, self.spec, outputs=req,
                         device=self.device)
        q = as_f32(queries, self.device)
        validate_batch_inputs(q, self.reference)
        impl = self.backend
        if self.auto_backend and impl.capabilities.unsupported_reason(
                self.spec, outputs=req, m=q.shape[1]) is not None:
            impl = registry.select(self.spec, outputs=req,
                                   device=self.device, m=q.shape[1])
        self.stats.calls += 1
        if self.normalize:
            q = normalize_batch(q)
        if impl.name != "kernel":
            return execute(impl, self.spec, q, self.reference, req,
                           self.segment_width)
        if "soft_alignment" in req or (
                self.spec.soft and torch.is_grad_enabled() and (
                    q.requires_grad or self.reference.requires_grad)):
            return execute(self.backend, self.spec, q, self.reference, req,
                           self.segment_width,
                           layouts=(self.layout(), self.layout(reverse=True)))
        sweep = sweep_outputs(req)
        extras = ()
        if self.spec.family != "sdtw":
            extras = self.family_extras() + ops.family_extras_query(
                self.spec, q)
        return from_sweep(ops.sdtw_wavefront_prepped(
            q, self.layout(), n=self.length,
            segment_width=self.segment_width, spec=self.spec,
            return_window="start" in sweep, extras=extras),
            sweep).restrict(req)

    __call__ = align

    def __repr__(self):
        return (f"Aligner(n={self.length}, backend={self.backend.name!r}, "
                f"spec={self.spec.describe()}, device={self.device})")
