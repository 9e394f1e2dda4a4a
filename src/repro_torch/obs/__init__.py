"""repro_torch.obs — metrics, tracing and logging for the port's layers.

Counterpart of ``repro.obs``:

  * :class:`MetricsRegistry` — thread-safe counters / gauges /
    histograms (p50/p95/p99), accumulated for the life of the process;
  * :class:`Tracer` + :func:`span` / :func:`trace` — nestable regions
    whose timers are device-sync-aware (``Span.sync(value)`` synchronizes
    the CUDA devices of in-flight tensors before the end timestamp when
    the tracer runs ``device_sync=True``);
  * exporters — metrics snapshots to JSON, span streams to JSONL and to
    Chrome ``chrome://tracing`` trace-event JSON;
  * :func:`configure_logging` — stdlib logging with the level read from
    ``REPRO_TORCH_LOG``;
  * :func:`machine_fingerprint` (``obs.bench``) — where a measurement
    ran, the tuning cache's trust boundary.

Instrumented layers (``backends.registry.select``,
``core.session.Aligner``, ``tune.autotune``) write to the process-wide
default registry and tracer unless handed their own::

    import repro_torch.obs as obs
    with obs.trace("my-run"):
        aligner(queries)
    obs.save_trace("trace.json")            # open in chrome://tracing
    print(obs.default_registry().snapshot())

Environment knobs: ``REPRO_TORCH_LOG=debug`` (log level),
``REPRO_TORCH_TRACE_SYNC=1`` (the default tracer synchronizes at span
exit — benchmark runs, not serving).
"""

from __future__ import annotations

import json
import logging
import os

from repro_torch.obs.bench import machine_fingerprint  # noqa: F401
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.tracing import (Span, Tracer,  # noqa: F401
                                     chrome_event, device_sync,
                                     load_chrome, load_jsonl)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Tracer", "chrome_event", "device_sync", "load_chrome",
    "load_jsonl", "machine_fingerprint",
    "default_registry", "default_tracer", "span", "trace",
    "save_trace", "save_metrics", "reset", "configure_logging",
]

_registry = MetricsRegistry()
_tracer = Tracer(metrics=_registry,
                 device_sync=os.environ.get("REPRO_TORCH_TRACE_SYNC", "")
                 not in ("", "0", "false"))


def default_registry() -> MetricsRegistry:
    """The process-wide registry every instrumented layer records to
    (unless constructed with an explicit ``metrics=``)."""
    return _registry


def default_tracer() -> Tracer:
    """The process-wide tracer behind :func:`span` / :func:`trace`."""
    return _tracer


def span(name: str, **args):
    """Open a span on the default tracer:
    ``with obs.span("aligner.dispatch") as sp: sp.sync(result)``."""
    return _tracer.span(name, **args)


# ``obs.trace("run")`` reads better at the top of a run script; same span.
trace = span


def save_trace(path, *, fmt: str | None = None) -> str:
    """Export the default tracer — Chrome trace-event JSON by default,
    JSONL when ``fmt="jsonl"`` (or the path ends in .jsonl).  Returns
    the path written."""
    if fmt is None:
        fmt = "jsonl" if str(path).endswith(".jsonl") else "chrome"
    if fmt == "jsonl":
        _tracer.export_jsonl(path)
    elif fmt == "chrome":
        _tracer.export_chrome(path)
    else:
        raise ValueError(f"unknown trace format {fmt!r} "
                         f"(use 'chrome' or 'jsonl')")
    return str(path)


def save_metrics(path) -> dict:
    """Write the default registry snapshot as JSON; returns it."""
    snap = _registry.snapshot()
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
    return snap


def reset() -> None:
    """Clear the default registry and tracer (tests / between runs)."""
    _registry.reset()
    _tracer.clear()


_LEVELS = {"critical": logging.CRITICAL, "error": logging.ERROR,
           "warning": logging.WARNING, "info": logging.INFO,
           "debug": logging.DEBUG}


def log_level(default: str = "info") -> int:
    """The level named by ``REPRO_TORCH_LOG`` (name or int), else
    default."""
    raw = os.environ.get("REPRO_TORCH_LOG", default).strip().lower()
    if raw.isdigit():
        return int(raw)
    try:
        return _LEVELS[raw]
    except KeyError:
        raise ValueError(
            f"REPRO_TORCH_LOG={raw!r}: use one of {sorted(_LEVELS)} or an "
            f"integer level") from None


def configure_logging(level: int | str | None = None, *,
                      force: bool = False) -> None:
    """Entry point for scripts: route the ``repro_torch`` loggers to stderr at
    the ``REPRO_TORCH_LOG`` level (library modules never call this —
    they only ``logging.getLogger(__name__)``)."""
    if level is None:
        level = log_level()
    elif isinstance(level, str):
        level = _LEVELS.get(level.strip().lower(), logging.INFO)
    root = logging.getLogger("repro_torch")
    if force:
        for h in list(root.handlers):
            root.removeHandler(h)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "[%(levelname).1s %(name)s] %(message)s"))
        root.addHandler(handler)
    root.setLevel(level)
