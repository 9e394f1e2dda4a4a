"""Aligner — an sDTW session for one reference.

The paper's §5 session: normalize the reference once, then stream
query batches against it::

    aligner = repro_torch.Aligner(reference, band=128)
    res = aligner(queries)
    res = aligner(queries, outputs=("cost", "start", "end"))

Counterpart of ``repro.core.session.Aligner``.  The reference is
normalized once at construction (one K2 launch on the card); the
kernel's reference layout is built once per segment width and cached;
each call normalizes its queries (one K2 launch) and runs one sweep
(one wavefront launch).  PyTorch runs eagerly, so there is no
executable cache: :class:`AlignerStats` counts calls and layout builds
only.
"""

from __future__ import annotations

import dataclasses

from repro_torch.backends import registry
from repro_torch.core.api import check_ported_outputs, check_width
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
            check_ported_outputs(hint)
        if backend is None:
            self.backend = registry.select(self.spec, outputs=hint,
                                           device=self.device)
        else:
            self.backend = registry.resolve(backend, self.spec,
                                            outputs=hint,
                                            device=self.device)
        self.normalize = normalize
        self.reference = normalize_batch(r) if normalize else r
        self.length = int(r.shape[0])
        self._layouts: dict = {}
        self.stats = AlignerStats()

    def layout(self, segment_width: int | None = None):
        """The kernel's reference layout for one width, built at most
        once per session."""
        w = self.segment_width if segment_width is None else \
            check_width(segment_width)
        lay = self._layouts.get(w)
        if lay is None:
            lay = self._layouts[w] = ops.prepare_reference(self.reference,
                                                           w)
            self.stats.layout_builds += 1
        return lay

    def align(self, queries, *, outputs=DEFAULT_OUTPUTS) -> SDTWResult:
        """Align one query batch (B, M) against the session's reference."""
        req = normalize_outputs(outputs)
        check_ported_outputs(req)
        registry.resolve(self.backend.name, self.spec, outputs=req,
                         device=self.device)
        q = as_f32(queries, self.device)
        validate_batch_inputs(q, self.reference)
        self.stats.calls += 1
        if self.normalize:
            q = normalize_batch(q)
        sweep = sweep_outputs(req)
        if self.backend.name == "kernel":
            res = from_sweep(ops.sdtw_wavefront_prepped(
                q, self.layout(), n=self.length,
                segment_width=self.segment_width, spec=self.spec,
                return_window="start" in sweep), sweep)
        else:
            res = self.backend.execute(self.spec, registry.ExecutionPlan(
                queries=q, reference=self.reference,
                segment_width=self.segment_width, outputs=sweep))
        return res.restrict(req)

    __call__ = align

    def __repr__(self):
        return (f"Aligner(n={self.length}, backend={self.backend.name!r}, "
                f"spec={self.spec.describe()}, device={self.device})")
