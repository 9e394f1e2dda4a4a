"""SDTWResult — one typed result for every sDTW request of the port.

A request names the artifacts it wants (``outputs``) and the result
carries exactly those fields, everything else ``None``; counterpart of
``repro.core.result``.  The port serves the sweep-level outputs
``cost``, ``end`` and ``start``, under hard-min (sdtw) ``path`` and,
under soft-min, ``soft_alignment``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

ALL_OUTPUTS = ("cost", "end", "start", "path", "soft_alignment")
DEFAULT_OUTPUTS = ("cost", "end")
SWEEP_OUTPUTS = frozenset({"cost", "end", "start"})


def normalize_outputs(outputs) -> frozenset:
    """Validate a requested-outputs value (one name or an iterable of
    names) into a frozenset; unknown names and empty requests raise."""
    if outputs is None:
        outputs = DEFAULT_OUTPUTS
    if isinstance(outputs, str):
        outputs = (outputs,)
    req = frozenset(outputs)
    unknown = req - frozenset(ALL_OUTPUTS)
    if unknown:
        raise ValueError(f"unknown output(s) {sorted(unknown)}; valid "
                         f"outputs are {ALL_OUTPUTS}")
    if not req:
        raise ValueError(f"outputs must name at least one of {ALL_OUTPUTS}")
    return req


def sweep_outputs(outputs) -> frozenset:
    """What the backend's sweep must produce: always cost and end, plus
    start when asked for (or for ``path``, whose traceback is pinned by
    the window), all from one sweep."""
    req = normalize_outputs(outputs)
    sweep = (req & SWEEP_OUTPUTS) | {"cost", "end"}
    if "path" in req:
        sweep |= {"start"}
    return frozenset(sweep)


@dataclasses.dataclass(frozen=True)
class SDTWResult:
    """Typed sDTW result; unrequested fields are ``None``."""

    cost: Any = None
    end: Any = None
    start: Any = None
    path: Any = None
    soft_alignment: Any = None

    @property
    def present(self) -> frozenset:
        """Names of the fields this result carries."""
        return frozenset(name for name in ALL_OUTPUTS
                         if getattr(self, name) is not None)

    def replace(self, **updates) -> "SDTWResult":
        return dataclasses.replace(self, **updates)

    def restrict(self, outputs) -> "SDTWResult":
        """Set every field not in ``outputs`` to ``None``."""
        req = normalize_outputs(outputs)
        return SDTWResult(**{name: (getattr(self, name) if name in req
                                    else None) for name in ALL_OUTPUTS})

    def window(self):
        """The windows triple ``(cost, start, end)``."""
        return self.cost, self.start, self.end


def from_sweep(out, outputs) -> SDTWResult:
    """Wrap a sweep's tuple — ``(cost, end)``, or ``(cost, start, end)``
    when ``"start" in outputs`` — into an :class:`SDTWResult`."""
    if "start" in outputs:
        cost, start, end = out
        return SDTWResult(cost=cost, end=end, start=start)
    cost, end = out
    return SDTWResult(cost=cost, end=end)
