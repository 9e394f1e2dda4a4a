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
that call.  ``outputs=("path",)`` adds each query's warping path,
recovered on the host inside the window of the same K3 sweep.
``segment_width="auto"`` tunes the kernel's width once per (query
length, batch bucket, sweep outputs) through ``repro_torch.tune`` (or
answers from its cache) and memoizes it.

PyTorch runs eagerly, so there is no executable cache: the JAX
session's ``aligner.compiles`` / ``cache_hits`` / ``evictions`` have no
counterpart.  :class:`AlignerStats` counts calls and layout builds; the
``aligner.calls`` counter and an ``aligner.dispatch`` span (which
synchronizes on the result when its tracer does) go to a
``repro_torch.obs`` registry and tracer.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.backends import registry
from repro_torch.core.api import check_width, derive_outputs, execute
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

    ``segment_width="auto"`` defers the width to ``repro_torch.tune``:
    the first call for each (query length, batch bucket, sweep outputs)
    key tunes the kernel's width (or answers from the tuning cache — a
    warm machine measures nothing), and every later call of that key
    dispatches the memoized width; results are bit-identical to a pinned
    width under hard-min.  ``tune_options`` forwards extras to
    :func:`repro_torch.tune.autotune` (``budget=``, ``cache=``,
    ``candidates=``, ``timer=``).  ``metrics`` / ``tracer``: the
    ``repro_torch.obs`` registry and tracer this session records into
    (default: the process-wide ones).
    """

    def __init__(self, reference, *, spec: DPSpec | None = None,
                 backend: str | None = None,
                 normalize: bool = True,
                 distance: str | None = None,
                 reduction: str | None = None,
                 gamma: float | None = None,
                 band: int | None = None,
                 outputs=None,
                 segment_width: int | str = 8,
                 device=None,
                 tune_options: dict | None = None,
                 metrics: obs.MetricsRegistry | None = None,
                 tracer: obs.Tracer | None = None):
        self.device = resolve_device(device)
        self.segment_width = check_width(segment_width)
        self._auto_width = self.segment_width == "auto"
        self.tune_options = dict(tune_options) if tune_options else {}
        self._tuned_widths: dict = {}   # (m, bucket, sweep-req) -> width
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
        self._metrics = obs.default_registry() if metrics is None else \
            metrics
        self._tracer = obs.default_tracer() if tracer is None else tracer

    def resolved_width(self, batch_shape, outputs=DEFAULT_OUTPUTS) -> int:
        """The segment width this session dispatches for a (B, M) batch
        shape and output request.

        A pinned-width session returns it as it is.  An ``"auto"``
        session on the kernel backend asks ``repro_torch.tune`` —
        memoized per (query length, batch bucket, sweep outputs), so the
        tuner (or its cache) is consulted once per workload; other
        backends ignore width and get the default.
        """
        if not self._auto_width:
            return self.segment_width
        if self.backend.name != "kernel":
            return ops.DEFAULT_SEGMENT_WIDTH
        from repro_torch import tune
        B, m = batch_shape
        req = sweep_outputs(normalize_outputs(outputs))
        key = (int(m), tune.batch_bucket(int(B)), req)
        w = self._tuned_widths.get(key)
        if w is None:
            res = tune.autotune(
                self.reference.detach(), m=int(m), batch=int(B),
                spec=self.spec, outputs=req, backends=("kernel",),
                device=self.device, metrics=self._metrics,
                tracer=self._tracer, **self.tune_options)
            w = self._tuned_widths[key] = res.segment_width
        return w

    def _width(self, segment_width: int | None) -> int:
        if segment_width is not None:
            return check_width(segment_width)
        if self._auto_width:
            raise ValueError(
                "segment_width='auto' sessions have no single layout; "
                "pass segment_width=... with a width from "
                "resolved_width()")
        return self.segment_width

    def layout(self, segment_width: int | None = None, *,
               reverse: bool = False):
        """The kernel's reference layout for one width (``reverse``: the
        reverse sweep's), built at most once per session."""
        w = self._width(segment_width)
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
        w = self._width(segment_width)
        ex = self._layouts.get((w, "family"))
        if ex is None:
            ex = self._layouts[(w, "family")] = ops.family_extras_ref(
                self.spec, self.reference.detach(), segment_width=w)
        return ex

    def align(self, queries, *, outputs=DEFAULT_OUTPUTS) -> SDTWResult:
        """Align one query batch (B, M) against the session's reference."""
        req = normalize_outputs(outputs)
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
        self._metrics.inc("aligner.calls")
        # a batch passed to the engine for its length ignores width
        w = (self.resolved_width(q.shape, req) if impl is self.backend
             else ops.DEFAULT_SEGMENT_WIDTH)
        if self.normalize:
            q = normalize_batch(q)
        with self._tracer.span("aligner.dispatch", backend=impl.name,
                               batch=list(q.shape), segment_width=w,
                               outputs=sorted(req)) as sp:
            res = self._sweep(impl, q, req, w)
            sp.sync(res)
        return derive_outputs(res, req, q, self.reference, self.spec)

    def _sweep(self, impl, q, req: frozenset, w: int) -> SDTWResult:
        """The sweep-level result of one call (``start`` included for a
        path request), over the session's cached layouts on the kernel
        backend."""
        if impl.name != "kernel":
            return execute(impl, self.spec, q, self.reference, req, w)
        if "soft_alignment" in req or (
                self.spec.soft and torch.is_grad_enabled() and (
                    q.requires_grad or self.reference.requires_grad)):
            return execute(impl, self.spec, q, self.reference, req, w,
                           layouts=(self.layout(w),
                                    self.layout(w, reverse=True)))
        sweep = sweep_outputs(req)
        extras = ()
        if self.spec.family != "sdtw":
            extras = self.family_extras(w) + ops.family_extras_query(
                self.spec, q)
        return from_sweep(ops.sdtw_wavefront_prepped(
            q, self.layout(w), n=self.length, segment_width=w,
            spec=self.spec, return_window="start" in sweep,
            extras=extras), sweep)

    __call__ = align

    def __repr__(self):
        return (f"Aligner(n={self.length}, backend={self.backend.name!r}, "
                f"spec={self.spec.describe()}, device={self.device})")
