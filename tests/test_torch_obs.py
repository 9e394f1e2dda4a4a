"""repro_torch.obs against repro.obs: the same seeded metric updates give
the same snapshot (quantiles included), spans nest and export alike and
the port's trace files load with the JAX package's loaders, and the
device-sync wait touches only CUDA tensors."""
import json

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import obs
from repro_torch.obs import tracing


@pytest.fixture
def jobs():
    """The JAX package's obs, imported here so the card-only tests of this
    file also run where JAX is not installed."""
    pytest.importorskip("jax")
    from repro import obs as jax_obs
    return jax_obs


def _drive(reg, seed: int, n: int):
    """One seeded sequence of inc / set_gauge / observe / add."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        op = int(rng.integers(4))
        name = f"m{int(rng.integers(3))}"
        if op == 0:
            reg.inc(f"c.{name}", int(rng.integers(0, 5)))
        elif op == 1:
            reg.set_gauge(f"g.{name}", float(rng.normal()))
        elif op == 2:
            reg.observe(f"h.{name}", float(rng.normal() * 10))
        else:
            reg.gauge(f"g.{name}").add(float(rng.normal()))


@pytest.mark.parametrize("seed,n", [(0, 7), (1, 200), (2, 2000)])
def test_snapshot_equals_jax(jobs, seed, n):
    port, ref = obs.MetricsRegistry(), jobs.MetricsRegistry()
    _drive(port, seed, n)
    _drive(ref, seed, n)
    assert port.snapshot() == ref.snapshot()
    assert port.names() == ref.names()


@pytest.mark.parametrize("q", [0.0, 0.3, 0.5, 0.95, 1.0])
def test_quantiles_are_numpy_linear(jobs, q):
    rng = np.random.default_rng(5)
    xs = rng.normal(size=333) * 7
    h, hj = obs.Histogram("x"), jobs.Histogram("x")
    for x in xs:
        h.record(float(x))
        hj.record(float(x))
    assert h.quantile(q) == hj.quantile(q) == pytest.approx(
        float(np.quantile(xs, q)), rel=1e-12, abs=1e-12)


def test_reservoir_past_max_samples_equals_jax(jobs):
    """Past ``max_samples`` both keep the same seeded reservoir."""
    h, hj = obs.Histogram("x", max_samples=16), jobs.Histogram(
        "x", max_samples=16)
    for x in np.random.default_rng(6).normal(size=500):
        h.record(float(x))
        hj.record(float(x))
    assert h.summary() == hj.summary()


def test_registry_errors_equal_jax(jobs):
    for mod in (obs, jobs):
        reg = mod.MetricsRegistry(max_names=2)
        reg.inc("a")
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("a")
        reg.inc("b")
        with pytest.raises(ValueError, match="max_names=2"):
            reg.inc("c")
        drop = mod.MetricsRegistry(max_names=2, overflow="drop")
        for name in "abc":
            drop.inc(name)
        assert drop.value("metrics.dropped_names") == 2
        with pytest.raises(ValueError, match="monotonic"):
            reg.inc("a", -1)


def test_nested_spans_and_exports_load_with_jax(jobs, tmp_path):
    reg = obs.MetricsRegistry()
    tr = obs.Tracer(metrics=reg)
    with tr.span("outer", run=1):
        with tr.span("inner") as sp:
            sp.set(rows=3)
        with tr.span("inner"):
            pass
    ev = tr.events
    assert [e["name"] for e in ev] == ["inner", "inner", "outer"]
    assert [e["depth"] for e in ev] == [1, 1, 0]
    assert ev[0]["parent"] == "outer" and ev[2]["parent"] is None
    assert ev[0]["args"] == {"rows": 3} and ev[2]["args"] == {"run": 1}
    assert reg.value("span.inner.ms") == 2
    jl, ch = tmp_path / "t.jsonl", tmp_path / "t.json"
    assert tr.export_jsonl(jl) == 3 and tr.export_chrome(ch) == 3
    assert jobs.load_jsonl(jl) == obs.load_jsonl(jl) == ev
    chrome = jobs.load_chrome(ch)
    assert chrome == obs.load_chrome(ch)
    assert chrome == [jobs.chrome_event(e) for e in ev]
    assert [e["ph"] for e in chrome] == ["X"] * 3
    assert chrome[0]["args"]["parent"] == "outer"


def test_error_span_is_flagged_and_not_synced(monkeypatch):
    calls = []
    monkeypatch.setattr(tracing, "device_sync", calls.append)
    tr = obs.Tracer(device_sync=True)
    with pytest.raises(RuntimeError):
        with tr.span("boom") as sp:
            sp.sync(torch.ones(2))
            raise RuntimeError("x")
    assert tr.events[0]["error"] is True
    assert tr.events[0]["synced"] is False and calls == []


def test_device_sync_on_cpu_tensors_does_nothing(monkeypatch):
    def forbid(*_):
        raise AssertionError("synchronized for a CPU tensor")
    monkeypatch.setattr(torch.cuda, "synchronize", forbid)
    res = repro_torch.SDTWResult(cost=torch.ones(3), end=torch.zeros(3))
    assert obs.device_sync([res, {"x": torch.ones(2)}, np.ones(2), 5]) == 0
    tr = obs.Tracer(device_sync=True)
    with tr.span("cpu") as sp:
        sp.sync(res)
    assert tr.events[0]["synced"] is True


def test_device_sync_waits_on_each_card_once(monkeypatch):
    """The devices are collected from inside results, lists and dicts,
    and each is synchronized once (a stand-in plays the CUDA tensor)."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)

    class Card(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 1)

    card = torch.ones(2).as_subclass(Card)
    res = repro_torch.SDTWResult(cost=card, end=card)
    assert obs.device_sync([res, (card,), {"k": card}]) == 1
    assert synced == [torch.device("cuda", 1)]


def test_default_tracer_save_and_reset(tmp_path):
    obs.reset()
    with obs.trace("run"):
        with obs.span("step"):
            pass
    path = obs.save_trace(tmp_path / "t.json")
    assert [e["name"] for e in obs.load_chrome(path)] == ["step", "run"]
    obs.save_trace(tmp_path / "t.jsonl")
    assert len(obs.load_jsonl(tmp_path / "t.jsonl")) == 2
    with pytest.raises(ValueError, match="unknown trace format"):
        obs.save_trace(tmp_path / "t.x", fmt="xml")
    snap = obs.save_metrics(tmp_path / "m.json")
    assert json.loads((tmp_path / "m.json").read_text()) == snap
    assert snap["span.run.ms"]["count"] == 1
    obs.reset()
    assert obs.default_tracer().events == []
    assert obs.default_registry().names() == []


def test_log_level_env(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_LOG", "debug")
    assert obs.log_level() == 10
    monkeypatch.setenv("REPRO_TORCH_LOG", "15")
    assert obs.log_level() == 15
    monkeypatch.setenv("REPRO_TORCH_LOG", "loud")
    with pytest.raises(ValueError, match="REPRO_TORCH_LOG"):
        obs.log_level()


def test_machine_fingerprint_names_the_device():
    fp = obs.machine_fingerprint("cpu")
    assert fp["device_type"] == "cpu" and fp["device_count"] == 1
    assert fp["torch"] == torch.__version__
    assert {"platform", "python", "cpu_count", "cuda",
            "device_name"} <= set(fp)


def test_aligner_records_calls_and_dispatch_spans():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 8)).astype(np.float32)
    r = rng.normal(size=(40,)).astype(np.float32)
    reg = obs.MetricsRegistry()
    tr = obs.Tracer(metrics=reg, device_sync=True)
    a = repro_torch.Aligner(r, device="cpu", metrics=reg, tracer=tr)
    a(q)
    a(q, outputs=("cost", "start", "end"))
    assert reg.value("aligner.calls") == 2
    spans = [e for e in tr.events if e["name"] == "aligner.dispatch"]
    assert len(spans) == 2 and all(e["synced"] for e in spans)
    assert spans[1]["args"]["outputs"] == ["cost", "end", "start"]
    assert reg.value("span.aligner.dispatch.ms") == 2


def test_registry_select_records_choice():
    from repro_torch.backends import registry
    reg = obs.default_registry()
    before = (reg.value("registry.select.calls"),
              reg.value("registry.select.engine"))
    registry.select(repro_torch.DPSpec(), device=torch.device("cpu"))
    assert reg.value("registry.select.calls") == before[0] + 1
    assert reg.value("registry.select.engine") == before[1] + 1
