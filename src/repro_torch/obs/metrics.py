"""Thread-safe metrics: counters, gauges, histograms with quantiles.

Counterpart of ``repro.obs.metrics``, kept as the port's own copy (the
module is pure Python).  The registry is the numeric half of
``repro_torch.obs`` (spans are the other half —
``repro_torch.obs.tracing``).  Hot paths record through it instead of
ad-hoc dataclasses so that

  * numbers ACCUMULATE — nothing resets silently between calls; a
    serving loop reads p50/p99 from the same registry its dispatches
    wrote to,
  * every layer shares one namespace (``aligner.calls``,
    ``tune.trials``, ``span.aligner.dispatch.ms``) that exports as
    a whole (:meth:`MetricsRegistry.snapshot`, JSON via
    ``repro_torch.obs.save_metrics``),
  * recording is cheap and thread-safe: one lock acquisition per
    update, no allocation on the counter/gauge paths.

Histogram quantiles follow numpy's default ``"linear"`` interpolation
(``np.quantile(values, q)``) exactly, so the benchmark reports match
what an offline numpy analysis of the same samples would say (held
to ``repro.obs``'s registry by ``tests/test_torch_obs.py``).
Histograms keep raw samples up to ``max_samples`` (exact quantiles);
beyond that new samples overwrite random earlier ones (reservoir
sampling — count/sum/min/max stay exact, quantiles become estimates).
"""

from __future__ import annotations

import math
import random
import threading


class Counter:
    """Monotonic counter. ``inc`` returns the post-increment value."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        if n < 0:
            raise ValueError(f"counter {self.name!r}: inc({n}) < 0 "
                             f"(counters are monotonic; use a Gauge)")
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        return self._value

    def summary(self) -> dict:
        return {"type": "counter", "value": self._value}

    def __repr__(self):
        return f"Counter({self.name!r}, value={self._value})"


class Gauge:
    """Last-write-wins instantaneous value (hit rates, occupancy)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += float(delta)

    @property
    def value(self) -> float:
        return self._value

    def summary(self) -> dict:
        return {"type": "gauge", "value": self._value}

    def __repr__(self):
        return f"Gauge({self.name!r}, value={self._value})"


class Histogram:
    """Sampled distribution with numpy-matched linear quantiles."""

    __slots__ = ("name", "max_samples", "_samples", "_count", "_sum",
                 "_min", "_max", "_lock", "_rng")

    def __init__(self, name: str, *, max_samples: int = 65536):
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.name = name
        self.max_samples = max_samples
        self._samples: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()
        self._rng = random.Random(0x0b5)     # deterministic reservoir

    def record(self, value: float) -> None:
        value = float(value)
        if not math.isfinite(value):
            raise ValueError(
                f"histogram {self.name!r}: non-finite sample {value}")
        with self._lock:
            self._count += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)
            if len(self._samples) < self.max_samples:
                self._samples.append(value)
            else:                            # reservoir: uniform over stream
                i = self._rng.randrange(self._count)
                if i < self.max_samples:
                    self._samples[i] = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> float:
        return self._min

    @property
    def max(self) -> float:
        return self._max

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else math.nan

    def quantile(self, q: float) -> float:
        """numpy's default linear interpolation over the kept samples."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            s = sorted(self._samples)
        if not s:
            return math.nan
        pos = q * (len(s) - 1)
        lo = math.floor(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] + (s[hi] - s[lo]) * frac

    def quantiles(self, qs=(0.5, 0.95, 0.99)) -> dict:
        return {f"p{round(q * 100):d}": self.quantile(q) for q in qs}

    def summary(self) -> dict:
        out = {"type": "histogram", "count": self._count}
        if self._count:
            out.update(sum=self._sum, min=self._min, max=self._max,
                       mean=self.mean, **self.quantiles())
        return out

    def __repr__(self):
        return f"Histogram({self.name!r}, count={self._count})"


class MetricsRegistry:
    """Named metrics, created on first touch, read as one snapshot.

    Names are dot-separated (``aligner.cache_hits``); re-requesting a
    name with a different metric type raises instead of shadowing.
    A process-wide default registry lives at
    :func:`repro_torch.obs.default_registry`; instrumented classes accept a
    ``metrics=`` override so tests assert on their own registries.

    **Cardinality guard.** Metric names are meant to be a small, static
    vocabulary — a caller interpolating per-query or per-key data into
    names (``tune.<workload-key>.ms``) would grow the registry without
    bound and poison every export.  ``max_names`` caps the number of
    distinct names (default 4096, far above legitimate use);
    ``overflow`` picks what happens at the cap: ``"error"`` (default)
    raises loudly naming the offender, ``"drop"`` returns a detached
    metric that records into the void while the registry's own
    ``metrics.dropped_names`` counter ticks — exports stay bounded,
    hot paths stay alive.
    """

    def __init__(self, *, max_names: int = 4096,
                 overflow: str = "error"):
        if max_names < 1:
            raise ValueError(f"max_names must be >= 1, got {max_names}")
        if overflow not in ("error", "drop"):
            raise ValueError(f"overflow must be 'error' or 'drop', "
                             f"got {overflow!r}")
        self.max_names = max_names
        self.overflow = overflow
        self._lock = threading.RLock()
        self._metrics: dict[str, object] = {}

    _DROPPED = "metrics.dropped_names"

    def _get(self, name: str, cls, **kw):
        if not name or not isinstance(name, str):
            raise ValueError(f"metric name must be a non-empty str, "
                             f"got {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                # drop mode reserves one slot for the guard's own
                # counter so the drop path can always account for itself
                cap = self.max_names
                if self.overflow == "drop" and \
                        self._DROPPED not in self._metrics and \
                        name != self._DROPPED:
                    cap -= 1
                if len(self._metrics) >= cap:
                    if self.overflow == "error":
                        raise ValueError(
                            f"metric registry at max_names="
                            f"{self.max_names}: refusing new name "
                            f"{name!r} — metric names must be a small "
                            f"static vocabulary, never interpolated "
                            f"per-key/per-query data (use "
                            f"MetricsRegistry(overflow='drop') to clamp "
                            f"instead)")
                    dropped = self._metrics.get(self._DROPPED)
                    if dropped is None:
                        dropped = self._metrics[self._DROPPED] = \
                            Counter(self._DROPPED)
                    dropped.inc()
                    return cls(name, **kw)      # detached, unregistered
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, *, max_samples: int = 65536) -> Histogram:
        return self._get(name, Histogram, max_samples=max_samples)

    # --------------------------------------------------- conveniences
    def inc(self, name: str, n: int = 1) -> int:
        return self.counter(name).inc(n)

    def set_gauge(self, name: str, value: float) -> None:
        self.gauge(name).set(value)

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).record(value)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, default=0):
        """Counter/gauge value (histograms: sample count)."""
        m = self.get(name)
        if m is None:
            return default
        return m.count if isinstance(m, Histogram) else m.value

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """{name: summary dict} — the exportable state of everything."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.summary() for name, m in sorted(items)}

    def reset(self) -> None:
        """Drop every metric (tests; NOT for steady-state serving —
        accumulation is the point)."""
        with self._lock:
            self._metrics.clear()

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._metrics

    def __repr__(self):
        return f"MetricsRegistry({len(self._metrics)} metrics)"
