"""Backend registry — one recurrence (``DPSpec``), several engines.

Each backend registers a :class:`Capabilities` declaration and an
``execute(spec, plan)`` entry point returning an
:class:`~repro_torch.core.result.SDTWResult`.  ``repro_torch.sdtw``
resolves a spec, asks the registry for a capable backend and executes;
an incapable request fails with an error that names who can serve it.
Auto-selection is shape-aware: given the query length ``m``, a backend
whose kernels cannot launch that long a query (``longest_query``)
declines, and the next capable one runs it.
An alias (``soft``) names a backend with spec fields overridden.
Counterpart of ``repro.backends.registry``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.result import DEFAULT_OUTPUTS, normalize_outputs
from repro_torch.core.spec import DPSpec

_BASE_OUTPUTS = frozenset(DEFAULT_OUTPUTS)


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend can execute.  Frozen: declared once at register."""

    distances: frozenset
    outputs: frozenset = _BASE_OUTPUTS   # SDTWResult fields it fills
    families: frozenset = frozenset({"sdtw"})
    #   recurrence families it executes; a backend opts in, so a family
    #   request never lands on one that would run sdtw instead
    window_families: frozenset = frozenset({"sdtw"})
    #   families it serves the "start" output for (twed / erp starts are
    #   column 0, or NO_WINDOW when the band blocks the corner)
    longest_query: Callable[[DPSpec, frozenset], int] | None = None
    #   (spec, requested outputs) -> the longest query it can run; None:
    #   any length

    def unsupported_reason(self, spec: DPSpec, outputs=None,
                           m: int | None = None) -> str | None:
        """None when the spec (and every requested output, at query
        length ``m`` when given) is executable, else a short reason."""
        if spec.family not in self.families:
            return f"family {spec.family!r}"
        if spec.distance not in self.distances:
            return f"distance {spec.distance!r}"
        if outputs is not None:
            req = normalize_outputs(outputs)
            # the family reasons first: they hold whatever a backend
            # declares, so "who can instead" names nobody falsely
            if "start" in req and spec.family not in self.window_families:
                return (f"output 'start' for family {spec.family!r} "
                        f"(window starts ride families "
                        f"{sorted(self.window_families)} here)")
            if "path" in req and spec.family != "sdtw":
                return (f"output 'path' for family {spec.family!r}: the "
                        "Hirschberg traceback recovers sdtw warping "
                        "paths only")
            if "soft_alignment" in req and spec.family != "sdtw":
                return ("output 'soft_alignment' for family "
                        f"{spec.family!r}: the soft-alignment backward "
                        "serves the sdtw recurrence only")
            missing = req - self.outputs
            if missing:
                return f"output(s) {sorted(missing)}"
            argmin = req & {"start", "path"}
            if argmin and spec.soft:
                return (f"output(s) {sorted(argmin)} under soft-min: no "
                        f"argmin path on a soft-min spec (hard-min only; "
                        f"ask outputs=('soft_alignment',) for the "
                        f"smoothed alignment)")
            if "soft_alignment" in req and not spec.soft:
                return ("output 'soft_alignment' under hard-min: the "
                        "expected alignment needs a softmin spec "
                        "(reduction='softmin'; hard-min paths are "
                        "outputs=('path',))")
        if m is not None and self.longest_query is not None:
            req = frozenset() if outputs is None \
                else normalize_outputs(outputs)
            longest = self.longest_query(spec, req)
            if m > longest:
                return (f"query length m={m} (its kernel launches queries "
                        f"of up to {longest} samples for this plan)")
        return None


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Everything an execute() needs besides the spec: the (already
    normalized) operands on their device, the requested sweep outputs,
    the kernel's segment width and, when a session keeps them, the
    kernel's (forward, reverse) reference layouts."""

    queries: Any
    reference: Any
    segment_width: int = 8
    outputs: frozenset = _BASE_OUTPUTS
    layouts: Any = None


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    capabilities: Capabilities
    execute: Callable[[DPSpec, ExecutionPlan], Any]   # -> SDTWResult

    def __call__(self, spec: DPSpec, plan: ExecutionPlan):
        return self.execute(spec, plan)


_REGISTRY: dict[str, Backend] = {}
_ALIASES: dict[str, tuple[str, dict]] = {}
_PRIORITY = ("engine", "kernel", "ref")


def _priority(device: torch.device) -> tuple:
    """Auto-selection order: on a CUDA device the wavefront kernel
    first; elsewhere the kernel would run its plain version, so the
    engine leads (``repro``'s rule puts the kernel first on TPU)."""
    if device.type == "cuda":
        return ("kernel",) + tuple(n for n in _PRIORITY if n != "kernel")
    return _PRIORITY


def register(backend: Backend, *, overwrite: bool = False) -> Backend:
    if not overwrite and backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def register_alias(alias: str, target: str, **spec_overrides) -> None:
    """An alias resolves to ``target`` with fields of the caller's spec
    overridden (``soft`` -> engine with ``reduction="softmin"``)."""
    _ALIASES[alias] = (target, spec_overrides)


def expand(name: str, spec: DPSpec) -> tuple[str, DPSpec]:
    """Alias expansion: (the target backend's name, the spec with the
    alias's overrides); a backend name comes back as it is."""
    _ensure_builtins()
    if name not in _ALIASES:
        return name, spec
    target, overrides = _ALIASES[name]
    return target, dataclasses.replace(spec, **overrides)


def _ensure_builtins() -> None:
    if "engine" not in _REGISTRY:
        from repro_torch.backends import builtin  # noqa: F401 (registers)


def names() -> list[str]:
    """Registered backends, then aliases."""
    _ensure_builtins()
    return sorted(_REGISTRY) + sorted(_ALIASES)


def get(name: str) -> Backend:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{names()}") from None


def capable(spec: DPSpec, *, outputs=None,
            device: torch.device = torch.device("cpu"),
            m: int | None = None) -> list[str]:
    """Backends able to execute ``spec`` and every requested output (on
    queries of length ``m`` when given), in the device's preference
    order."""
    _ensure_builtins()
    ordered = [n for n in _priority(device) if n in _REGISTRY]
    ordered += [n for n in sorted(_REGISTRY) if n not in ordered]
    return [n for n in ordered
            if _REGISTRY[n].capabilities.unsupported_reason(
                spec, outputs=outputs, m=m) is None]


def resolve(name: str, spec: DPSpec, *, outputs=None,
            device: torch.device = torch.device("cpu")) -> Backend:
    """The named backend, or a capability error naming who can."""
    backend = get(name)
    reason = backend.capabilities.unsupported_reason(spec, outputs=outputs)
    if reason is not None:
        alternatives = [n for n in capable(spec, outputs=outputs,
                                           device=device) if n != name]
        hint = f": use one of {alternatives}" if alternatives else ""
        raise ValueError(f"backend {name!r} does not support {reason} "
                         f"(spec {spec.describe()}){hint}")
    return backend


def select(spec: DPSpec, *, outputs=None,
           device: torch.device = torch.device("cpu"),
           m: int | None = None) -> Backend:
    """The first capable backend in the device's preference order; with
    the query length ``m``, one that can run queries that long (a named
    backend, :func:`resolve`, is not asked: the kernel raises its own
    shaped error)."""
    choices = capable(spec, outputs=outputs, device=device, m=m)
    if not choices:
        what = f"spec {spec.describe()}"
        if outputs is not None:
            what += f" with outputs={sorted(normalize_outputs(outputs))}"
        reason = _REGISTRY["engine"].capabilities.unsupported_reason(
            spec, outputs=outputs)
        why = f" (engine: {reason})" if reason else ""
        raise ValueError(f"no registered backend supports {what}{why}")
    return _REGISTRY[choices[0]]
