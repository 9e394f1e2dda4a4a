"""repro_torch.tune against repro.tune: the same workload keys and batch
buckets, the same hill-climb under the same scripted timer, the cache's
round trip, rejection and expiry, a machine key per device, and
``segment_width="auto"`` through ``sdtw`` and ``Aligner`` giving the
pinned width's bits (the plain versions on the CPU; on the card, K1 and
K3)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import tune
from repro_torch.backends import registry
from repro_torch.core.spec import DPSpec, resolve_spec
from repro_torch.kernels import ops, wavefront
from repro_torch.obs import MetricsRegistry, Tracer, machine_fingerprint

WIDTHS = (2, 4, 8, 14, 16, 32)
N_KEY = 1200     # every width survives the padding rule in both packages

# the spec matrix of the key parity test (and of the hill-climb's)
SPECS = {
    "default": dict(),
    "abs": dict(distance="abs"),
    "band": dict(band=12),
    "soft": dict(reduction="softmin", gamma=0.5),
    "twed": dict(family="twed", nu=0.5, lam=0.75),
    "erp": dict(family="erp", gap=0.25),
    "local": dict(family="local", gap_penalty=0.6, match_reward=1.1),
}


@pytest.fixture(autouse=True)
def mem_cache():
    """A memory-only default cache for the CPU, restored afterwards: no
    test touches a tuning file outside its tmp_path."""
    prev = tune.set_default_cache(tune.TuningCache(None, device="cpu"),
                                  device="cpu")
    yield tune.default_cache("cpu")
    tune.set_default_cache(prev, device="cpu")


@pytest.fixture
def jtune():
    """The JAX package's tune and spec, imported here so the card-only
    tests of this file also run where JAX is not installed."""
    pytest.importorskip("jax")
    from repro import tune as jax_tune
    from repro.core.spec import DPSpec as JaxSpec
    from repro.obs import MetricsRegistry as JaxRegistry
    return jax_tune, JaxSpec, JaxRegistry


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((5, 20)).astype(np.float32)
    r = rng.standard_normal(300).astype(np.float32)
    return q, r


def fake_timer(times: dict, default: float = 9.9):
    """timer(label, make_fn) stub returning scripted seconds; records
    the call order so budget tests can count trials."""
    calls = []

    def timer(label, make_fn):
        calls.append(label)
        return times.get(label, default)

    timer.calls = calls
    return timer


def _spec(name):
    return resolve_spec(None, **SPECS[name])


# ------------------------------------------------------ keys and buckets
@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("outputs", [("cost", "end"),
                                     ("cost", "start", "end")])
def test_workload_key_equals_jax(jtune, name, outputs):
    jax_tune, JaxSpec, _ = jtune
    spec = _spec(name)
    jspec = JaxSpec(**dataclasses.asdict(spec))
    for m, n, b in ((20, 700, 8), (2000, 100_000, 512)):
        assert tune.workload_key(spec=spec, m=m, n=n, batch_bucket=b,
                                 outputs=frozenset(outputs)) == \
            jax_tune.workload_key(spec=jspec, m=m, n=n, batch_bucket=b,
                                  outputs=frozenset(outputs))


def test_batch_bucket_equals_jax(jtune):
    jax_tune = jtune[0]
    for b in list(range(1, 70)) + [100, 511, 512, 513, 4095, 4096, 9000]:
        assert tune.batch_bucket(b) == jax_tune.batch_bucket(b)
    assert tune.batch_bucket(1) == 8 and tune.batch_bucket(9000) == 4096
    with pytest.raises(ValueError):
        tune.batch_bucket(0)


# ----------------------------------------------------------- the climb
@pytest.mark.parametrize("name,times", [
    ("default", {"engine": 5.0, "kernel:w8": 3.0, "kernel:w4": 2.0,
                 "kernel:w2": 2.5, "kernel:w14": 4.0}),
    ("default", {"engine": 5.0, "kernel:w8": 3.0, "kernel:w14": 2.0,
                 "kernel:w16": 1.5, "kernel:w32": 1.7}),
    ("band", {"engine": 1.0, "kernel:w8": 7.0, "kernel:w4": 6.0}),
    ("twed", {"engine": 5.0, "kernel:w8": 3.0, "kernel:w14": 1.0}),
    ("soft", {}),
])
def test_climb_equals_jax(jtune, name, times):
    """Same scripted times: the same winner, after the same trials in
    the same order."""
    jax_tune, JaxSpec, JaxRegistry = jtune
    spec = _spec(name)
    r = np.zeros(N_KEY, np.float32)
    pt, jt = fake_timer(times), fake_timer(times)
    got = tune.autotune(r, m=20, batch=5, spec=spec, device="cpu",
                        cache=tune.TuningCache(None, device="cpu"),
                        metrics=MetricsRegistry(), timer=pt)
    want = jax_tune.autotune(r, m=20, batch=5,
                             spec=JaxSpec(**dataclasses.asdict(spec)),
                             interpret=True,
                             cache=jax_tune.TuningCache(None),
                             metrics=JaxRegistry(), timer=jt)
    assert pt.calls == jt.calls
    assert (got.backend, got.segment_width, got.key, got.trials) == \
        (want.backend, want.segment_width, want.key, want.trials)
    assert dict(got.measured) == dict(want.measured)


def test_budget_max_trials_respected(data):
    _, r = data
    timer = fake_timer({})
    m = MetricsRegistry()
    res = tune.autotune(r, m=20, batch=5, device="cpu",
                        cache=tune.TuningCache(None, device="cpu"),
                        budget=tune.TuneBudget(max_trials=2), metrics=m,
                        timer=timer)
    assert len(timer.calls) == 2 == m.value("tune.trials") == res.trials
    with pytest.raises(ValueError):
        tune.TuneBudget(max_trials=0)
    with pytest.raises(ValueError):
        tune.TuneBudget(runs=0)


def test_tune_span_recorded(data):
    _, r = data
    tr = Tracer()
    tune.autotune(r, m=20, batch=5, device="cpu",
                  cache=tune.TuningCache(None, device="cpu"),
                  metrics=MetricsRegistry(), tracer=tr,
                  timer=fake_timer({"kernel:w4": 1.0}))
    (ev,) = [e for e in tr.events if e["name"] == "tune.search"]
    assert ev["args"]["winner"] == "kernel:w4"
    assert ev["args"]["trials"] == 5    # engine, w8, w4, w14, w2


def test_engine_winner_still_records_best_kernel_width(data):
    _, r = data
    times = {"engine": 1.0, "kernel:w8": 7.0, "kernel:w4": 6.0,
             "kernel:w2": 8.0}
    res = tune.autotune(r, m=20, batch=5, candidates=WIDTHS, device="cpu",
                        cache=tune.TuningCache(None, device="cpu"),
                        metrics=MetricsRegistry(), timer=fake_timer(times))
    assert (res.backend, res.segment_width) == ("engine", 4)


def test_a_failing_trial_raises(data, monkeypatch):
    """Unlike repro, a trial's exception propagates: a kernel that fails
    must not hide behind an engine verdict, and nothing is cached."""
    _, r = data
    cache = tune.TuningCache(None, device="cpu")

    def broken(label, make_fn):
        if label.startswith("kernel"):
            raise RuntimeError("kernel failed to launch")
        return 1.0
    with pytest.raises(RuntimeError, match="failed to launch"):
        tune.autotune(r, m=20, batch=5, device="cpu", cache=cache,
                      metrics=MetricsRegistry(), timer=broken)
    assert len(cache) == 0

    def boom(*a, **k):
        raise RuntimeError("no kernel image")
    monkeypatch.setattr(ops, "sdtw_wavefront", boom)
    with pytest.raises(RuntimeError, match="no kernel image"):
        tune.autotune(r, m=20, batch=5, device="cpu", cache=cache,
                      backends=("kernel",), metrics=MetricsRegistry(),
                      budget=tune.TuneBudget(warmup=0, runs=1))
    with pytest.raises(ValueError, match="cannot tune backend"):
        tune.autotune(r, m=20, batch=5, device="cpu", cache=cache,
                      backends=("ref",), timer=fake_timer({}))


def test_untunable_spec_answers_the_default(data):
    """Cosine runs on no kernel: a kernel-only tune measures nothing and
    answers the engine at width 8; an open one times the engine alone."""
    _, r = data
    m = MetricsRegistry()
    cache = tune.TuningCache(None, device="cpu")
    res = tune.autotune(r, m=20, batch=5, spec=DPSpec(distance="cosine"),
                        backends=("kernel",), device="cpu", cache=cache,
                        metrics=m, timer=fake_timer({}))
    assert (res.backend, res.segment_width, res.trials) == ("engine", 8, 0)
    assert m.value("tune.trials") == 0 and len(cache) == 0
    timer = fake_timer({})
    res = tune.autotune(r, m=20, batch=5, spec=DPSpec(distance="cosine"),
                        device="cpu", cache=cache, metrics=m, timer=timer)
    assert timer.calls == ["engine"] and res.backend == "engine"


def test_a_query_longer_than_the_kernel_drops_it():
    """longest_query does not depend on width: past it the kernel is no
    candidate at all, and the engine is timed alone."""
    m_long = wavefront.longest_query(DPSpec()) + 1
    timer = fake_timer({})
    res = tune.autotune(np.zeros(50_000, np.float32), m=m_long, batch=1,
                        device="cpu",
                        cache=tune.TuningCache(None, device="cpu"),
                        metrics=MetricsRegistry(), timer=timer)
    assert timer.calls == ["engine"] and res.backend == "engine"


# ---------------------------------------------------------- the cache
def test_cache_round_trip_and_warm_zero_trials(tmp_path, data):
    _, r = data
    path = str(tmp_path / "tuning.json")
    cold = MetricsRegistry()
    res1 = tune.autotune(r, m=20, batch=5, device="cpu",
                         cache=tune.TuningCache(path, device="cpu"),
                         metrics=cold, timer=fake_timer({"kernel:w4": 1.0}))
    assert cold.value("tune.trials") == res1.trials > 0
    assert cold.value("tune.cache_hits") == 0
    doc = json.loads((tmp_path / "tuning.json").read_text())
    assert doc["schema"] == tune.TUNE_SCHEMA == "repro_torch.tune/v1"
    (section,) = doc["machines"].values()
    assert section["fingerprint"]["device_type"] == "cpu"

    def exploding(label, make_fn):
        raise AssertionError("a warm cache must not measure")
    warm = MetricsRegistry()
    res2 = tune.autotune(r, m=20, batch=5, device="cpu",
                         cache=tune.TuningCache(path, device="cpu"),
                         metrics=warm, timer=exploding)
    assert res2.from_cache and res2.trials == 0
    assert warm.value("tune.trials") == 0
    assert warm.value("tune.cache_hits") == 1
    assert (res2.backend, res2.segment_width) == ("kernel", 4)


@pytest.mark.parametrize("corrupt", [
    "not json at all {",
    json.dumps({"schema": "repro.tune/v1", "machines": {}}),
    json.dumps(["wrong", "shape"]),
    json.dumps({"schema": "repro_torch.tune/v1", "machines": "nope"}),
])
def test_corrupt_cache_rejected(tmp_path, corrupt):
    path = tmp_path / "tuning.json"
    path.write_text(corrupt)
    c = tune.TuningCache(str(path), device="cpu")
    assert c.rejected and len(c) == 0
    key = c.key(spec=DPSpec(), m=8, n=100, batch_bucket=8,
                outputs=("cost",))
    c.put(key, {"backend": "engine", "segment_width": 8})
    assert not tune.TuningCache(str(path), device="cpu").rejected


def test_malformed_entries_dropped(tmp_path):
    path = tmp_path / "tuning.json"
    mkey = tune.machine_key(machine_fingerprint("cpu"))
    path.write_text(json.dumps({
        "schema": tune.TUNE_SCHEMA,
        "machines": {mkey: {"entries": {
            "good": {"backend": "kernel", "segment_width": 4},
            "bad_width": {"backend": "kernel", "segment_width": 0},
            "bad_bool": {"backend": "kernel", "segment_width": True},
            "bad_type": "not a dict",
            "bad_ms": {"backend": "kernel", "segment_width": 4,
                       "best_ms": float("nan")},
        }}}}))
    c = tune.TuningCache(str(path), device="cpu")
    assert c.rejected and list(c.entries()) == ["good"]
    with pytest.raises(ValueError, match="malformed"):
        c.put("k", {"backend": "kernel", "segment_width": -1})


def test_stale_fingerprint_and_over_age_expire(tmp_path):
    from repro_torch import obs
    import time
    path = tmp_path / "tuning.json"
    fp = machine_fingerprint("cpu")
    mkey = tune.machine_key(fp)
    entries = {"w1": {"backend": "kernel", "segment_width": 4},
               "w2": {"backend": "engine", "segment_width": 2}}

    def write(fingerprint, stamp=None):
        section = {"fingerprint": fingerprint, "entries": entries}
        if stamp is not None:
            section["updated_unix"] = stamp
        path.write_text(json.dumps({"schema": tune.TUNE_SCHEMA,
                                    "machines": {mkey: section}}))

    stale = dict(fp, torch="0.0.archaeology")
    assert tune.machine_key(stale) != mkey
    write(stale)
    before = obs.default_registry().value("tune.cache_expired")
    c = tune.TuningCache(str(path), device="cpu")
    assert len(c) == 0 and c.expired == 2 and not c.rejected
    assert obs.default_registry().value("tune.cache_expired") == before + 2
    write(fp, stamp=time.time() - 3600)
    assert tune.TuningCache(str(path), device="cpu").expired == 0
    old = tune.TuningCache(str(path), device="cpu", max_age_s=60.0)
    assert len(old) == 0 and old.expired == 2
    assert len(tune.TuningCache(str(path), device="cpu",
                                max_age_s=7200.0)) == 2
    write(fp)        # no stamp: cannot prove its age under a bound
    assert tune.TuningCache(str(path), device="cpu",
                            max_age_s=60.0).expired == 2
    with pytest.raises(ValueError, match="max_age_s"):
        tune.TuningCache(str(path), device="cpu", max_age_s=0)


def test_cache_file_and_env_knobs(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    assert tune.default_cache_path().endswith(
        "/.cache/repro_torch/tuning.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", "/elsewhere/jax.json")
    assert tune.default_cache_path().endswith("repro_torch/tuning.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", "off")
    assert tune.default_cache_path() is None
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", "/x/y.json")
    assert tune.default_cache_path() == "/x/y.json"
    from repro_torch.tune import cache as cache_mod
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE_MAX_AGE", "86400")
    assert cache_mod._default_max_age() == 86400.0
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE_MAX_AGE", "soon")
    assert cache_mod._default_max_age() is None


def test_a_card_verdict_never_answers_a_cpu_call(tmp_path, data):
    """The machine key names the device: a CPU fingerprint and a CUDA
    one differ, their sections of one file stay apart, and a card's
    cache refuses a device='cpu' tune."""
    _, r = data
    cpu = machine_fingerprint("cpu")
    card = dict(cpu, device_type="cuda",
                device_name="NVIDIA H100 80GB HBM3", device_count=1)
    assert tune.machine_key(cpu) != tune.machine_key(card)
    path = str(tmp_path / "tuning.json")
    on_card = tune.TuningCache(path, fingerprint=card)
    key = on_card.key(spec=DPSpec(), m=20, n=len(r), batch_bucket=8,
                      outputs=frozenset({"cost", "end"}))
    on_card.put(key, {"backend": "kernel", "segment_width": 16})
    on_cpu = tune.TuningCache(path, device="cpu")
    assert on_cpu.get(key) is None
    on_cpu.put(key, {"backend": "engine", "segment_width": 8})
    doc = json.loads((tmp_path / "tuning.json").read_text())
    assert len(doc["machines"]) == 2
    assert tune.TuningCache(path, fingerprint=card).get(key)[
        "segment_width"] == 16
    with pytest.raises(ValueError, match="holds verdicts of machine"):
        tune.autotune(r, m=20, batch=5, device="cpu", cache=on_card,
                      timer=fake_timer({}))
    assert tune.default_cache("cpu").machine == tune.machine_key(cpu)


def test_cross_shape_seeding(data):
    _, r = data
    cache = tune.TuningCache(None, device="cpu")
    times = {"engine": 5.0, "kernel:w8": 3.0, "kernel:w4": 2.0,
             "kernel:w2": 2.5, "kernel:w14": 4.0}
    m1 = MetricsRegistry()
    res1 = tune.autotune(r, m=20, batch=5, device="cpu", cache=cache,
                         metrics=m1, timer=fake_timer(times))
    assert (res1.segment_width, m1.value("tune.seeded_starts")) == (4, 0)
    m2 = MetricsRegistry()
    timer = fake_timer(times)
    res2 = tune.autotune(r, m=24, batch=5, device="cpu", cache=cache,
                         metrics=m2, timer=timer)
    assert m2.value("tune.seeded_starts") == 1
    assert res2.segment_width == 4 and not res2.from_cache
    assert [c for c in timer.calls if c.startswith("kernel:")][0] == \
        "kernel:w4"
    assert "kernel:w8" in res2.measured     # the default still measured
    # another family's verdict never seeds this one
    m3 = MetricsRegistry()
    tune.autotune(r, m=24, batch=5, spec=_spec("erp"), device="cpu",
                  cache=cache, metrics=m3, timer=fake_timer(times))
    assert m3.value("tune.seeded_starts") == 0


# ------------------------------------------------- auto through the API
@pytest.mark.parametrize("outputs", [("cost", "end"),
                                     ("cost", "start", "end")])
@pytest.mark.parametrize("band", [None, 12])
def test_width_parity_matrix(data, outputs, band):
    """Every width gives the same bits on the plain versions: tuning is
    free to pick any of them."""
    q, r = data
    base = None
    for w in WIDTHS:
        res = repro_torch.sdtw(q, r, outputs=outputs, backend="kernel",
                               segment_width=w, band=band, device="cpu")
        got = {o: getattr(res, o) for o in outputs}
        if base is None:
            base = got
            continue
        for o in outputs:
            assert torch.equal(got[o], base[o]), (w, o, band)


def test_soft_width_parity(data):
    q, r = data
    costs = [repro_torch.sdtw(q, r, backend="kernel", gamma=0.5,
                              segment_width=w, device="cpu").cost
             for w in WIDTHS]
    for c in costs[1:]:
        torch.testing.assert_close(c, costs[0], rtol=1e-6, atol=1e-6)


BUDGET = tune.TuneBudget(max_trials=3, warmup=0, runs=1)


@pytest.mark.parametrize("outputs", [("cost", "end"),
                                     ("cost", "start", "end")])
def test_auto_sdtw_and_aligner_bit_identical_to_pinned(data, outputs):
    q, r = data
    m = MetricsRegistry()
    auto = repro_torch.Aligner(r, backend="kernel", segment_width="auto",
                               device="cpu", metrics=m,
                               tune_options={"budget": BUDGET})
    got = auto(q, outputs=outputs)
    assert m.value("tune.trials") > 0
    one_shot = repro_torch.sdtw(q, r, backend="kernel", outputs=outputs,
                                segment_width="auto", device="cpu")
    for w in WIDTHS:
        pin = repro_torch.sdtw(q, r, backend="kernel", outputs=outputs,
                               segment_width=w, device="cpu")
        for o in outputs:
            assert torch.equal(getattr(got, o), getattr(pin, o))
            assert torch.equal(getattr(one_shot, o), getattr(pin, o))


def test_auto_aligner_warm_cache_zero_trials(tmp_path, data):
    q, r = data
    path = str(tmp_path / "t.json")
    m1 = MetricsRegistry()
    a1 = repro_torch.Aligner(
        r, backend="kernel", segment_width="auto", device="cpu",
        metrics=m1, tune_options={"budget": BUDGET, "cache":
                                  tune.TuningCache(path, device="cpu")})
    r1 = a1(q)
    assert m1.value("tune.trials") > 0
    m2 = MetricsRegistry()
    a2 = repro_torch.Aligner(
        r, backend="kernel", segment_width="auto", device="cpu",
        metrics=m2, tune_options={"budget": BUDGET, "cache":
                                  tune.TuningCache(path, device="cpu")})
    r2 = a2(q)
    assert m2.value("tune.trials") == 0
    assert m2.value("tune.cache_hits") == 1
    assert torch.equal(r1.cost, r2.cost)
    a2(q)        # memoized per workload: not even a cache lookup
    assert m2.value("tune.cache_hits") == 1
    assert a2.resolved_width(q.shape) == a1.resolved_width(q.shape)


def test_auto_sdtw_front_door(data, mem_cache):
    """Unpinned: the tuner times kernel against engine, and either
    answer is the sweep's cost; warm, no trial."""
    q, r = data
    res = repro_torch.sdtw(q, r, segment_width="auto", device="cpu")
    ref = repro_torch.sdtw(q, r, backend="engine", device="cpu")
    torch.testing.assert_close(res.cost, ref.cost, rtol=1e-5, atol=1e-5)
    assert len(mem_cache) == 1
    from repro_torch import obs
    before = obs.default_registry().value("tune.trials")
    repro_torch.sdtw(q, r, segment_width="auto", device="cpu")
    assert obs.default_registry().value("tune.trials") == before
    with pytest.raises(ValueError, match="or 'auto'"):
        repro_torch.sdtw(q, r, segment_width="fastest", device="cpu")
    with pytest.raises(ValueError, match="or 'auto'"):
        repro_torch.Aligner(r, segment_width="fastest", device="cpu")


def test_auto_width_non_kernel_backend_skips_tuning(data):
    q, r = data
    m = MetricsRegistry()
    a = repro_torch.Aligner(r, backend="engine", segment_width="auto",
                            device="cpu", metrics=m)
    a(q)
    assert m.value("tune.trials") == 0
    assert a.resolved_width(q.shape) == ops.DEFAULT_SEGMENT_WIDTH
    res = repro_torch.sdtw(q, r, backend="ref", segment_width="auto",
                           device="cpu")
    assert res.cost.shape == (5,)


def test_auto_soft_and_family_through_the_kernel(data):
    q, r = data
    for kw in (dict(gamma=0.5), dict(family="twed", nu=0.5, lam=0.75)):
        got = repro_torch.sdtw(q, r, backend="kernel",
                               segment_width="auto", device="cpu", **kw)
        pin = repro_torch.sdtw(q, r, backend="kernel", segment_width=8,
                               device="cpu", **kw)
        torch.testing.assert_close(got.cost, pin.cost, rtol=1e-6,
                                   atol=1e-6)


def test_layout_requires_width_under_auto(data):
    _, r = data
    a = repro_torch.Aligner(r, backend="kernel", segment_width="auto",
                            device="cpu")
    with pytest.raises(ValueError, match="auto"):
        a.layout()
    with pytest.raises(ValueError, match="auto"):
        a.family_extras()
    assert a.layout(segment_width=4).shape == ops.prepare_reference(
        a.reference, 4).shape


def test_registry_select_consults_verdict(data, mem_cache):
    """A measured verdict re-ranks auto-selection (on the CPU the static
    priority picks the engine); the query-length filter still holds."""
    _, r = data
    spec = DPSpec()
    cpu = torch.device("cpu")
    tune.autotune(r, m=20, batch=5, spec=spec, device="cpu",
                  metrics=MetricsRegistry(),
                  timer=fake_timer({"engine": 5.0, "kernel:w8": 1.0}))
    from repro_torch import obs
    before = obs.default_registry().value("registry.select.kernel")
    assert registry.select(spec, device=cpu,
                           workload=(20, len(r), 5)).name == "kernel"
    assert obs.default_registry().value("registry.select.kernel") == \
        before + 1
    assert registry.select(spec, device=cpu,
                           workload=(21, len(r), 5)).name == "engine"
    m_long = wavefront.longest_query(spec) + 1
    key = mem_cache.key(spec=spec, m=m_long, n=len(r), batch_bucket=8,
                        outputs=frozenset({"cost", "end"}))
    mem_cache.put(key, {"backend": "kernel", "segment_width": 8})
    assert registry.select(spec, device=cpu,
                           workload=(m_long, len(r), 5)).name == "engine"


# ------------------------------------------------------------- on card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest -m gpu` on the H100")
    dev = torch.device("cuda")
    prev = tune.set_default_cache(tune.TuningCache(None, device=dev),
                                  device=dev)
    yield dev
    tune.set_default_cache(prev, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("outputs,variant", [(("cost", "end"), "K1"),
                                             (("cost", "start", "end"),
                                              "K3")])
def test_auto_on_card_bit_equal_to_w8(cuda, outputs, variant):
    rng = np.random.default_rng(11)
    q = rng.normal(size=(16, 64)).astype(np.float32)
    r = rng.normal(size=(4_000,)).astype(np.float32)
    m = MetricsRegistry()
    wavefront.counter.reset()
    got = repro_torch.sdtw(q, r, backend="kernel", outputs=outputs,
                           segment_width="auto", device=cuda)
    torch.cuda.synchronize()
    assert wavefront.counter.by_variant.get(variant, 0) > 1  # the trials
    pin = repro_torch.sdtw(q, r, backend="kernel", outputs=outputs,
                           segment_width=8, device=cuda)
    for o in outputs:
        assert torch.equal(getattr(got, o), getattr(pin, o))
    a = repro_torch.Aligner(r, backend="kernel", segment_width="auto",
                            device=cuda, metrics=m)
    res = a(q, outputs=outputs)
    assert m.value("tune.cache_hits") == 1 and m.value("tune.trials") == 0
    for o in outputs:
        assert torch.equal(getattr(res, o), getattr(pin, o))
