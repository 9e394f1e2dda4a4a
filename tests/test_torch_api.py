"""The port's front door and session against the JAX package's:
repro_torch.sdtw / Aligner (device="cpu") vs repro.sdtw / repro.Aligner,
the state carried across by repro_torch.convert, and the port's
capability and validation errors."""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # every test here runs the JAX package too

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core.normalize import normalize_batch as jax_normalize_batch  # noqa: E402,E501
from repro.core.spec import DPSpec as JaxSpec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.spec import NotPortedError  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)


def _inputs(b, m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, m)).astype(np.float32) * 2 + 1,
            rng.normal(size=(n,)).astype(np.float32) * 3 - 2)


def _same(port, jax_res, outputs):
    np.testing.assert_allclose(port.cost.numpy(), np.asarray(jax_res.cost),
                               **TOL)
    np.testing.assert_array_equal(port.end.numpy(), np.asarray(jax_res.end))
    if "start" in outputs:
        np.testing.assert_array_equal(port.start.numpy(),
                                      np.asarray(jax_res.start))
    else:
        assert port.start is None


@pytest.mark.parametrize("backend", ["kernel", "engine"])
@pytest.mark.parametrize("outputs", [("cost", "end"),
                                     ("cost", "start", "end")])
@pytest.mark.parametrize("band,distance", [(None, "sqeuclidean"),
                                           (7, "abs")])
def test_sdtw_matches_repro(backend, outputs, band, distance):
    q, r = _inputs(5, 24, 300, seed=1)
    want = repro.sdtw(q, r, outputs=outputs, backend="engine", band=band,
                      distance=distance)
    got = repro_torch.sdtw(q, r, outputs=outputs, backend=backend,
                           band=band, distance=distance, segment_width=4,
                           device="cpu")
    assert got.present == frozenset(outputs)
    _same(got, want, outputs)


def test_sdtw_ref_backend_and_auto_selection():
    q, r = _inputs(2, 8, 60, seed=2)
    want = repro.sdtw(q, r, outputs=("cost", "start", "end"), backend="ref")
    got = repro_torch.sdtw(q, r, outputs=("cost", "start", "end"),
                           backend="ref", device="cpu")
    _same(got, want, ("start",))
    auto = repro_torch.sdtw(q, r, device="cpu")
    _same(auto, want, ())
    from repro_torch.backends import registry
    assert registry.select(repro_torch.DPSpec(),
                           device=torch.device("cpu")).name == "engine"
    assert registry.select(repro_torch.DPSpec(),
                           device=torch.device("cuda")).name == "kernel"


# (spec fields, outputs, the kernel's longest query): K1, K3, K4, K5,
# the K6 pair, hard K7 and soft K7
LONGEST = [
    ({}, ("cost", "end"), 26_912),
    ({}, ("cost", "start", "end"), 18_145),
    ({"band": 900}, ("cost", "end"), 26_912),
    ({"reduction": "softmin", "gamma": 0.5}, ("cost", "end"), 26_912),
    ({"reduction": "softmin", "gamma": 0.5}, ("soft_alignment",), 26_912),
    ({"family": "twed", "nu": 0.5, "lam": 0.75}, ("cost", "end"), 26_912),
    ({"family": "local", "reduction": "softmin", "gap_penalty": 0.6,
      "match_reward": 1.1}, ("cost", "end"), 26_912)]
LONGEST_IDS = ["K1", "K3", "K4", "K5", "K6", "K7-hard", "K7-soft"]


@pytest.mark.parametrize("fields,outputs,longest", LONGEST, ids=LONGEST_IDS)
def test_auto_selection_falls_back_past_the_longest_query(fields, outputs,
                                                         longest):
    """On a CUDA device the kernel leads up to its plan's longest query
    and the engine takes longer ones; no length keeps today's answer.
    Only the registry is asked: no sweep runs."""
    from repro_torch.backends import registry
    from repro_torch.core.spec import resolve_spec
    spec = resolve_spec(None, **fields)
    cuda = torch.device("cuda")

    def pick(m):
        return registry.select(spec, outputs=outputs, device=cuda, m=m).name
    assert pick(None) == "kernel"
    assert pick(longest) == "kernel"
    assert pick(longest + 1) == "engine"
    assert registry.capable(spec, outputs=outputs, device=cuda,
                            m=longest + 1) == ["engine", "ref"]
    reason = registry.get("kernel").capabilities.unsupported_reason(
        spec, outputs=outputs, m=longest + 1)
    assert f"m={longest + 1}" in reason and str(longest) in reason
    # on the CPU the engine leads whatever the length
    assert registry.select(spec, outputs=outputs,
                           m=longest + 1).name == "engine"


@pytest.mark.parametrize("fields,outputs,longest", LONGEST, ids=LONGEST_IDS)
def test_explicit_kernel_keeps_its_shaped_error(fields, outputs, longest):
    """backend="kernel" is not re-routed: a query one sample past the
    kernel's longest raises the wrapper's shared-memory error before any
    sweep runs."""
    q, r = _inputs(1, longest + 1, longest + 1, seed=9)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        repro_torch.sdtw(q, r, outputs=outputs, backend="kernel",
                         device="cpu", **fields)


@pytest.fixture
def card_order_and_short_kernel(monkeypatch):
    """Selection as on a CUDA device (the kernel first) on CPU tensors,
    with the kernel's longest query cut to 24 samples, and a record of
    the kernel's sweeps (``ops.sdtw_wavefront_prepped``)."""
    from repro_torch.backends import registry
    from repro_torch.kernels import ops, wavefront
    order = registry._priority(torch.device("cuda"))
    monkeypatch.setattr(registry, "_priority", lambda device: order)
    monkeypatch.setattr(wavefront, "longest_query", lambda spec, **kw: 24)
    swept = []
    sweep = ops.sdtw_wavefront_prepped

    def recorded(queries, *args, **kwargs):
        swept.append(queries.shape[1])
        return sweep(queries, *args, **kwargs)
    monkeypatch.setattr(ops, "sdtw_wavefront_prepped", recorded)
    return swept


@pytest.mark.parametrize("gamma", [None, 0.5])
def test_sdtw_and_aligner_fall_back_per_call(card_order_and_short_kernel,
                                            gamma):
    swept = card_order_and_short_kernel
    kw = {} if gamma is None else dict(reduction="softmin", gamma=gamma)
    q_short = _inputs(3, 24, 1, seed=11)[0]
    q_long, r = _inputs(3, 25, 200, seed=12)
    al = repro_torch.Aligner(r, device="cpu", **kw)
    assert al.backend.name == "kernel"
    al(q_short)
    assert swept == [24]
    engine = repro_torch.sdtw(q_long, r, backend="engine", device="cpu", **kw)
    for got in (al(q_long), repro_torch.sdtw(q_long, r, device="cpu", **kw)):
        assert torch.equal(got.cost, engine.cost)
        assert torch.equal(got.end, engine.end)
    assert swept == [24]
    want = repro.sdtw(q_long, r, backend="engine", **kw)
    _same(engine, want, ("cost", "end"))
    assert al.stats.calls == 2
    # a named backend is not re-routed: the kernel's plain version runs
    repro_torch.sdtw(q_long, r, backend="kernel", device="cpu", **kw)
    assert swept == [24, 25]


def test_fallback_keeps_autograd(card_order_and_short_kernel):
    """The engine's autograd reaches the queries and the reference on the
    fallback path, through the Aligner and make_sdtw_loss."""
    from repro_torch.train.step import make_sdtw_loss
    q_np, r_np = _inputs(3, 25, 200, seed=13)

    def grads(run):
        q = torch.from_numpy(q_np).requires_grad_()
        r = torch.from_numpy(r_np).requires_grad_()
        run(q, r).backward()
        return q.grad, r.grad
    want = grads(lambda q, r: repro_torch.sdtw(
        q, r, gamma=0.5, backend="engine", device="cpu").cost.sum())
    for run in (lambda q, r: repro_torch.Aligner(
                    r, gamma=0.5, reduction="softmin",
                    device="cpu")(q).cost.sum(),
                lambda q, r: make_sdtw_loss(r, gamma=0.5, device="cpu",
                                            reduce="sum")(q)):
        got = grads(run)
        for a, b in zip(got, want):
            assert a is not None and bool(a.abs().sum() > 0)
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert card_order_and_short_kernel == []


@pytest.mark.parametrize("band", [None, 12])
def test_aligner_from_jax_session(band):
    r = _inputs(1, 1, 400, seed=3)[1]
    jax_al = repro.Aligner(r, backend="engine", band=band)
    port_al = convert.aligner_from_numpy(
        np.asarray(jax_al.reference), dataclasses.asdict(jax_al.spec),
        device="cpu", segment_width=8, backend="kernel")
    assert port_al.normalize is False
    np.testing.assert_array_equal(port_al.reference.numpy(),
                                  np.asarray(jax_al.reference))
    for i, outputs in enumerate([("cost", "end"), ("cost", "start", "end"),
                                 ("cost", "end")]):
        q = _inputs(3 + i, 30, 1, seed=10 + i)[0]
        want = jax_al(q, outputs=outputs)
        got = port_al(np.asarray(jax_normalize_batch(q)), outputs=outputs)
        _same(got, want, outputs)
    assert port_al.stats.as_dict() == {"calls": 3, "layout_builds": 1}


def test_aligner_normalizes_reference_once():
    q, r = _inputs(4, 20, 250, seed=4)
    al = repro_torch.Aligner(r, backend="kernel", segment_width=2,
                             device="cpu")
    one_shot = repro_torch.sdtw(q, r, backend="kernel", segment_width=2,
                                outputs=("cost", "start", "end"),
                                device="cpu")
    for _ in range(2):
        res = al(q, outputs=("cost", "start", "end"))
        for name in ("cost", "start", "end"):
            assert torch.equal(getattr(res, name), getattr(one_shot, name))
    assert al.stats.calls == 2 and al.stats.layout_builds == 1


def test_spec_from_dict():
    d = dataclasses.asdict(JaxSpec(distance="abs", band=5))
    spec = convert.spec_from_dict(d)
    assert dataclasses.asdict(spec) == d
    soft = dataclasses.asdict(JaxSpec(reduction="softmin", gamma=0.25))
    assert dataclasses.asdict(convert.spec_from_dict(soft)) == soft
    fam = dataclasses.asdict(JaxSpec(family="twed", nu=0.5, lam=0.75,
                                     band=4))
    assert dataclasses.asdict(convert.spec_from_dict(fam)) == fam
    assert convert.spec_from_dict(fam).describe() == JaxSpec(
        **fam).describe()
    with pytest.raises(NotPortedError, match="accum_dtype"):
        convert.spec_from_dict({**d, "accum_dtype": "bfloat16"})
    with pytest.raises(ValueError, match="unknown DPSpec field"):
        convert.spec_from_dict({**d, "mystery": 1})


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(reduction="softmin", gamma=0.0), ValueError, "gamma > 0"),
    (dict(gamma=0.5, outputs=("cost", "start")), ValueError,
     "under soft-min"),
    (dict(family="erp", outputs=("cost", "path")), ValueError,
     "output 'path' for family 'erp'"),
    (dict(gamma=0.5, outputs=("cost", "path")), ValueError,
     "under soft-min"),
    (dict(outputs="soft_alignment"), ValueError, "under hard-min"),
    (dict(distance="cosine", backend="kernel"), ValueError,
     r"backend 'kernel' does not support distance 'cosine'.*\['engine', "
     r"'ref'\]"),
    (dict(outputs="bogus"), ValueError, "unknown output"),
    (dict(backend="quantized"), ValueError, "unknown backend"),
])
def test_capability_errors(kwargs, error, match):
    q, r = _inputs(2, 8, 40, seed=5)
    with pytest.raises(error, match=match):
        repro_torch.sdtw(q, r, device="cpu", **kwargs)


def test_cosine_runs_on_the_engine():
    """Scalar cosine costs are near 0 or near 2, so the bottom row is
    full of near-ties and the end follows rounding: the end is held to
    the port's own row-scan ref, the cost to repro."""
    q, r = _inputs(2, 8, 40, seed=6)
    want = repro.sdtw(q, r, distance="cosine", backend="engine")
    got = repro_torch.sdtw(q, r, distance="cosine", device="cpu")
    ref = repro_torch.sdtw(q, r, distance="cosine", device="cpu",
                           backend="ref")
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               **TOL)
    np.testing.assert_array_equal(got.end.numpy(), ref.end.numpy())


@pytest.mark.parametrize("width,error,match", [
    (True, ValueError, "int >= 1"), (0, ValueError, ">= 1"),
    (-2, ValueError, ">= 1"), (2.0, ValueError, "int >= 1"),
    (3, ValueError, "no wavefront kernel instantiation"),
    ("fastest", ValueError, "or 'auto'"),
])
def test_segment_width_validation(width, error, match):
    q, r = _inputs(2, 8, 40, seed=7)
    with pytest.raises(error, match=match):
        repro_torch.sdtw(q, r, segment_width=width, device="cpu")
    with pytest.raises(error, match=match):
        repro_torch.Aligner(r, segment_width=width, device="cpu")


def test_input_shape_errors():
    q, r = _inputs(2, 8, 40, seed=8)
    with pytest.raises(ValueError, match="queries must be 2-D"):
        repro_torch.sdtw(q[0], r, device="cpu")
    with pytest.raises(ValueError, match="reference must be 1-D"):
        repro_torch.sdtw(q, q, device="cpu")
    with pytest.raises(ValueError, match="empty query batch"):
        repro_torch.sdtw(q[:0], r, device="cpu")
    with pytest.raises(ValueError, match="empty reference"):
        repro_torch.Aligner(r[:0], device="cpu")


def test_result_helpers():
    res = repro_torch.SDTWResult(cost=1, end=2, start=3)
    assert res.present == {"cost", "end", "start"}
    assert res.restrict(("cost",)) == repro_torch.SDTWResult(cost=1)
    assert res.window() == (1, 3, 2)
    assert res.replace(end=5).end == 5
