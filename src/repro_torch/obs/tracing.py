"""Nestable, device-sync-aware span tracing + JSONL / Chrome exporters.

Counterpart of ``repro.obs.tracing``.  CUDA launches are asynchronous:
``fn(x)`` returns the instant the kernel is *enqueued*, so a naive
``perf_counter`` pair around a launch times the Python overhead, not the
sweep.  A :class:`Span` therefore accepts device values via
:meth:`Span.sync`; when the tracer runs with ``device_sync=True`` the
span synchronizes the CUDA devices those values live on
(:func:`device_sync`) *before* reading its end timestamp, so the
recorded duration covers the device work.  Values on the CPU need no
wait.  ``device_sync=False`` (the serving default — synchronizing every
dispatch would serialize the pipeline) skips the wait and tags the
event ``synced: False`` so a reader knows the number is enqueue-side.

Spans nest through a per-thread stack: each finished event records its
depth and parent span, and completed events are appended in finish
order (children before parents).

Exporters:

  * :meth:`Tracer.export_jsonl` — one event dict per line, loadable
    with :func:`load_jsonl`;
  * :meth:`Tracer.export_chrome` — Chrome trace-event JSON (open in
    ``chrome://tracing`` or https://ui.perfetto.dev): complete ``"X"``
    events, microsecond timestamps relative to the tracer epoch.

The process-wide default tracer is at
``repro_torch.obs.default_tracer()``; ``repro_torch.obs.trace(...)`` /
``repro_torch.obs.span(...)`` open spans on it.  Set
``REPRO_TORCH_TRACE_SYNC=1`` to make the default tracer synchronize at
span exit (benchmark runs); tests construct their own
``Tracer(device_sync=True)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import torch

from repro_torch.obs.metrics import MetricsRegistry


def _cuda_devices(value, out: set) -> None:
    """Collect the CUDA devices of the tensors inside ``value`` (tensors,
    dataclass results, lists, tuples and dict values)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)


def device_sync(values) -> int:
    """Wait for the work behind ``values``: ``torch.cuda.synchronize`` on
    each CUDA device a tensor in them lives on.  CPU tensors, numpy
    arrays and plain Python values need no wait.  Returns the number of
    devices synchronized."""
    devices: set = set()
    _cuda_devices(values, devices)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return len(devices)


class Span:
    """One open region.  Mutate via :meth:`set` (attributes shown in the
    exported ``args``) and :meth:`sync` (device values to wait for at
    exit when the tracer is device_sync)."""

    __slots__ = ("name", "args", "start_ns", "end_ns", "depth", "parent",
                 "_sync_values")

    def __init__(self, name: str, args: dict, depth: int,
                 parent: str | None):
        self.name = name
        self.args = args
        self.depth = depth
        self.parent = parent
        self.start_ns = 0
        self.end_ns = 0
        self._sync_values: list = []

    def set(self, **kw) -> "Span":
        self.args.update(kw)
        return self

    def sync(self, value) -> "Span":
        """Register a (possibly still in-flight) device value; the span
        end timestamp is taken only after its device is synchronized."""
        self._sync_values.append(value)
        return self

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _SpanCtx:
    """Context manager binding one Span to one Tracer."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        self._tracer._enter(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        self._tracer._exit(self.span, error=exc_type is not None)
        return False


class Tracer:
    """Collects finished spans; thread-safe, nestable per thread.

    ``metrics``: optional :class:`MetricsRegistry` — every finished span
    also records its duration into the ``span.<name>.ms`` histogram, so
    quantiles over repeated regions (p50/p99 dispatch latency) come for
    free.  ``device_sync``: synchronize the devices of values registered
    via :meth:`Span.sync` before timing the exit (see module docstring).
    """

    def __init__(self, *, metrics: MetricsRegistry | None = None,
                 device_sync: bool = False, max_events: int = 1_000_000):
        self.metrics = metrics
        self.device_sync = bool(device_sync)
        self.max_events = max_events
        self.epoch_ns = time.perf_counter_ns()
        self._events: list[dict] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    # ------------------------------------------------------------ spans
    def span(self, name: str, **args) -> _SpanCtx:
        """``with tracer.span("search.topk", queries=8) as sp: ...``"""
        stack = self._stack()
        parent = stack[-1].name if stack else None
        return _SpanCtx(self, Span(name, args, depth=len(stack),
                                   parent=parent))

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _enter(self, span: Span) -> None:
        self._stack().append(span)
        span.start_ns = time.perf_counter_ns()

    def _exit(self, span: Span, *, error: bool) -> None:
        synced = False
        if self.device_sync and span._sync_values and not error:
            device_sync(span._sync_values)
            synced = True
        span.end_ns = time.perf_counter_ns()
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        event = {
            "name": span.name,
            "ts_ns": span.start_ns - self.epoch_ns,
            "dur_ns": span.duration_ns,
            "depth": span.depth,
            "parent": span.parent,
            "tid": threading.get_ident(),
            "pid": os.getpid(),
            "synced": synced,
        }
        if error:
            event["error"] = True
        if span.args:
            event["args"] = dict(span.args)
        with self._lock:
            if len(self._events) < self.max_events:
                self._events.append(event)
            else:
                self._dropped += 1
        if self.metrics is not None:
            self.metrics.observe(f"span.{span.name}.ms",
                                 span.duration_ns / 1e6)

    # ----------------------------------------------------------- access
    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def active_depth(self) -> int:
        return len(self._stack())

    # -------------------------------------------------------- exporters
    def export_jsonl(self, path) -> int:
        """One JSON event per line; returns the number written."""
        events = self.events
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return len(events)

    def export_chrome(self, path) -> int:
        """Chrome trace-event format (chrome://tracing, Perfetto)."""
        events = self.events
        doc = {"traceEvents": [chrome_event(e) for e in events],
               "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)


def chrome_event(e: dict) -> dict:
    """One obs event -> one Chrome complete ('X') trace event."""
    out = {
        "name": e["name"],
        "ph": "X",
        "ts": e["ts_ns"] / 1e3,          # microseconds
        "dur": e["dur_ns"] / 1e3,
        "pid": e["pid"],
        "tid": e["tid"],
        "cat": e["name"].split(".", 1)[0],
    }
    args = dict(e.get("args") or {})
    args["synced"] = e.get("synced", False)
    if e.get("parent"):
        args["parent"] = e["parent"]
    out["args"] = args
    return out


def load_jsonl(path) -> list[dict]:
    """Round-trip loader for :meth:`Tracer.export_jsonl`."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def load_chrome(path) -> list[dict]:
    """Load a Chrome trace file's traceEvents list (sanity checks the
    container shape so a malformed export fails loudly)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a Chrome trace (no traceEvents "
                         f"list)")
    return events
