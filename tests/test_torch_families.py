"""The recurrence families of the port (twed / erp / local: spec, row-scan
ref, engine, K7's plain version through the kernel backend, Aligner,
dp.score, registry) against the JAX package's ref, engine and float64
oracle on the CPU; on the card, K7 against its plain version."""
import dataclasses
import itertools
import types

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import dp
from repro_torch.core import engine
from repro_torch.core.spec import DPSpec, resolve_spec
from repro_torch.kernels import family, ops, wavefront

FAMS = ("twed", "erp", "local")
PARAMS = dict(nu=0.5, lam=0.75, gap=0.25, gap_penalty=0.6,
              match_reward=1.1, gamma=0.7)
B, M, N = 3, 26, 30           # |M - N| = 4: band 8 keeps the corner,
#                               band 2 cuts it off (tests/test_dp_families.py)
N3 = 2 * 64 + 22              # three chunks at w = 2, the last ragged


def spec_for(family_, distance="sqeuclidean", reduction="hardmin",
             band=None):
    return resolve_spec(None, family=family_, distance=distance,
                        reduction=reduction, band=band, **PARAMS)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((B, M)).astype(np.float32),
            rng.standard_normal(N).astype(np.float32))


@pytest.fixture
def jx():
    """The JAX side, imported in a fixture so that the card-only tests
    also run where JAX is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import engine as jengine, ref as jref
    from repro.core.spec import resolve_spec as jresolve
    from repro.dp.oracle import dp_oracle

    def spec(**kw):
        return jresolve(None, **kw)

    def run(fn, q, r, s):
        return [np.asarray(x) for x in fn(jnp.asarray(q), jnp.asarray(r),
                                          s)]

    return types.SimpleNamespace(
        spec=spec, oracle=dp_oracle,
        ref=lambda q, r, s: run(jref.sdtw_ref, q, r, s),
        engine=lambda q, r, s: run(
            lambda a, b, c: jengine.sdtw_engine(a, b, spec=c,
                                                return_end=True), q, r, s))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest -m gpu` on the H100")
    return torch.device("cuda")


def run(q, r, spec, backend, **kw):
    res = repro_torch.sdtw(q, r, spec=spec, backend=backend, normalize=False,
                           outputs=("cost", "end"), device="cpu", **kw)
    return res.cost, res.end


# ---------------------------------------------- ref, engine vs repro
@pytest.mark.parametrize("band", [None, 8])
@pytest.mark.parametrize("reduction", ["hardmin", "softmin"])
@pytest.mark.parametrize("distance", ["sqeuclidean", "abs", "cosine"])
@pytest.mark.parametrize("family_", FAMS)
def test_ref_engine_match_repro_and_oracle(data, jx, family_, distance,
                                           reduction, band):
    q, r = data
    spec = spec_for(family_, distance, reduction, band)
    jspec = jx.spec(**dataclasses.asdict(spec))
    ref_c, ref_e = run(q, r, spec, "ref")
    eng_c, eng_e = run(q, r, spec, "engine")
    # the engine is the row scan re-ordered into anti-diagonals: the same
    # float32 operations, the same bits
    assert torch.equal(eng_c, ref_c) and torch.equal(eng_e, ref_e)
    oracle = [jx.oracle(q[b], r, jspec) for b in range(B)]
    want_c = np.array([c for c, _ in oracle])
    for got_c, got_e in ((ref_c, ref_e), (eng_c, eng_e)):
        np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-5,
                                   atol=1e-5)
    for c, e in (jx.ref(q, r, jspec), jx.engine(q, r, jspec)):
        np.testing.assert_allclose(ref_c.numpy(), c, rtol=1e-5, atol=1e-5)
        if not (family_ == "local" and distance == "cosine"):
            # cosine's near-ties: repro's own test skips this end too
            np.testing.assert_array_equal(ref_e.numpy(), e)
    if not (family_ == "local" and distance == "cosine"):
        np.testing.assert_array_equal(ref_e.numpy(),
                                      [e for _, e in oracle])


@pytest.mark.parametrize("family_", FAMS)
def test_port_oracle_is_repro_oracle(data, jx, family_):
    """The port's float64 oracle is a copy: the same numbers."""
    q, r = data
    for reduction, band in itertools.product(("hardmin", "softmin"),
                                             (None, 8, 2)):
        spec = spec_for(family_, reduction=reduction, band=band)
        jspec = jx.spec(**dataclasses.asdict(spec))
        for b in range(B):
            assert dp.dp_oracle(q[b], r, spec) == jx.oracle(q[b], r, jspec)


def test_window_starts_of_the_global_families(data, jx):
    q, r = data
    for family_, band in (("twed", None), ("erp", 8), ("twed", 2)):
        spec = spec_for(family_, band=band)
        for backend in ("ref", "engine"):
            res = repro_torch.sdtw(q, r, spec=spec, backend=backend,
                                   normalize=False, device="cpu",
                                   outputs=("cost", "start", "end"))
            blocked = band == 2
            assert res.start.tolist() == [-1 if blocked else 0] * B
            assert res.end.tolist() == [0 if blocked else N - 1] * B


# ------------------------------------- K7's plain version vs engine
@pytest.mark.parametrize("width", [2, 8])
@pytest.mark.parametrize("band", [None, 8])
@pytest.mark.parametrize("reduction", ["hardmin", "softmin"])
@pytest.mark.parametrize("distance", ["sqeuclidean", "abs"])
@pytest.mark.parametrize("family_", FAMS)
def test_kernel_plain_matches_engine(data, family_, distance, reduction,
                                     band, width):
    """The kernel backend on a CPU tensor runs K7's plain version over
    the zero-padded layout: bit-equal to the engine under hard-min,
    within 1e-4 under soft-min, ends equal."""
    q, r = data
    spec = spec_for(family_, distance, reduction, band)
    eng_c, eng_e = run(q, r, spec, "engine")
    ker_c, ker_e = run(q, r, spec, "kernel", segment_width=width)
    if reduction == "hardmin":
        assert torch.equal(ker_c, eng_c)
    else:
        torch.testing.assert_close(ker_c, eng_c, rtol=1e-4, atol=1e-4)
    assert torch.equal(ker_e, eng_e)


@pytest.mark.parametrize("reduction", ["hardmin", "softmin"])
@pytest.mark.parametrize("family_", FAMS)
def test_kernel_plain_on_a_ragged_multichunk_reference(family_, reduction):
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 20)).astype(np.float32)
    r = rng.standard_normal(N3).astype(np.float32)
    spec = spec_for(family_, reduction=reduction,
                    band=None if family_ != "local" else 40)
    eng_c, eng_e = run(q, r, spec, "engine")
    ker_c, ker_e = run(q, r, spec, "kernel", segment_width=2)
    if reduction == "hardmin":
        assert torch.equal(ker_c, eng_c)
    else:
        torch.testing.assert_close(ker_c, eng_c, rtol=1e-4, atol=1e-4)
    assert torch.equal(ker_e, eng_e)
    assert wavefront.num_chunks(N3, 2) == 3


def test_local_fold_skips_the_zero_pad_columns():
    """Queries near 0 against a reference far from 0: the layout's zero
    pad columns would make the best local alignment, so the plain
    version's j < n guard is what keeps the answer right."""
    q = np.full((2, 12), 0.01, np.float32)
    r = np.where(np.arange(70) % 2 == 0, 3.0, -3.0).astype(np.float32)
    spec = spec_for("local")
    want_c, want_e = run(q, r, spec, "engine")
    got_c, got_e = run(q, r, spec, "kernel", segment_width=2)
    assert torch.equal(got_c, want_c) and torch.equal(got_e, want_e)
    assert float(want_c[0]) == pytest.approx(dp.dp_oracle(q[0], r, spec)[0])
    # the trap is real: folding the pad columns too scores better
    lay = ops.prepare_reference(torch.from_numpy(r), 2)
    unguarded, _ = engine.sdtw_engine(torch.from_numpy(q), lay, spec=spec)
    assert bool((unguarded < want_c - 1).all())


# --------------------------------------------------- blocked bands
@pytest.mark.parametrize("backend", ["ref", "engine", "kernel"])
@pytest.mark.parametrize("family_", ["twed", "erp"])
def test_band_disconnects_global_corner(data, monkeypatch, family_,
                                        backend):
    """band < |M - N| leaves no path to a global family's corner: (inf,
    0) everywhere, and the kernel backend answers without K7."""
    q, r = data
    monkeypatch.setattr(family, "family_wavefront", None)
    for reduction in ("hardmin", "softmin"):
        spec = spec_for(family_, reduction=reduction, band=2)
        cost, end = run(q, r, spec, backend)
        assert bool(torch.isinf(cost).all()) and end.tolist() == [0] * B
    assert ops.band_blocked(M, N, 2, family_)
    assert not ops.band_blocked(M, N, 4, family_)


def test_local_never_blocked(data):
    q, r = data
    assert not ops.band_blocked(M, N, 0, "local")
    for backend in ("ref", "engine", "kernel"):
        cost, _ = run(q, r, spec_for("local", band=2), backend)
        assert bool(torch.isfinite(cost).all() & (cost <= 0).all())


# ------------------------------------------------------ front doors
@pytest.mark.parametrize("backend", ["kernel", "engine"])
@pytest.mark.parametrize("family_", FAMS)
def test_aligner_matches_one_shot(data, family_, backend):
    q, r = data
    for reduction in ("hardmin", "softmin"):
        spec = spec_for(family_, reduction=reduction)
        one = run(q, r, spec, backend, segment_width=2)
        al = repro_torch.Aligner(r, spec=spec, backend=backend,
                                 normalize=False, segment_width=2,
                                 device="cpu")
        for _ in range(2):
            res = al(q)
            assert torch.equal(res.cost, one[0])
            assert torch.equal(res.end, one[1])
        assert al.stats.calls == 2
    if backend == "kernel":
        assert al.stats.layout_builds == 1
        assert len(al.family_extras()) == (family_ != "local")


def test_dp_score_and_sdtw_family_unchanged(data):
    q, r = data
    got = dp.score(q, r, family="erp", gap=0.25, backend="engine",
                   normalize=False, device="cpu")
    want = repro_torch.sdtw(q, r, family="erp", gap=0.25, backend="engine",
                            normalize=False, device="cpu")
    assert torch.equal(got.cost, want.cost)
    assert torch.equal(got.end, want.end)
    a = repro_torch.sdtw(q, r, backend="engine", device="cpu")
    b = repro_torch.sdtw(q, r, backend="engine", family="sdtw", device="cpu")
    c = dp.score(q, r, backend="engine", device="cpu")
    assert torch.equal(a.cost, b.cost) and torch.equal(a.cost, c.cost)
    assert dp.recurrence("local").fold == "cells"
    assert dp.FAMILY_RECURRENCES["twed"].fold == "corner"


def test_family_spec_matches_repro(jx):
    for family_ in FAMS:
        for kw in (dict(), dict(reduction="softmin", band=3)):
            spec = spec_for(family_, **kw)
            jspec = jx.spec(**dataclasses.asdict(spec))
            assert spec.describe() == jspec.describe()
            assert dataclasses.asdict(spec.recurrence) == \
                dataclasses.asdict(jspec.recurrence)
    for kw, match in ((dict(family="twed", nu=-1.0), "nu >= 0"),
                      (dict(family="local", gap_penalty=0.0),
                       "gap_penalty > 0"),
                      (dict(family="local", match_reward=0.0),
                       "match_reward > 0"),
                      (dict(family="bogus"), "unknown recurrence family")):
        with pytest.raises(ValueError, match=match):
            DPSpec(**kw)
    with pytest.raises(ValueError, match="unknown recurrence family"):
        dp.recurrence("bogus")


# ------------------------------------------------ registry and errors
@pytest.mark.parametrize("kwargs,match", [
    (dict(family="erp", outputs=("cost", "path")),
     "output 'path' for family 'erp'"),
    (dict(family="twed", gamma=0.5, outputs="soft_alignment"),
     "output 'soft_alignment' for family 'twed'"),
    (dict(family="local", outputs=("cost", "start"), backend="engine"),
     "output 'start' for family 'local'"),
    (dict(family="twed", outputs=("cost", "start"), backend="kernel"),
     r"output 'start' for family 'twed'.*use one of \['engine', 'ref'\]"),
    (dict(family="local", distance="cosine", backend="kernel"),
     r"distance 'cosine'.*\['engine', 'ref'\]"),
])
def test_registry_names_who_can(data, kwargs, match):
    q, r = data
    with pytest.raises(ValueError, match=match):
        repro_torch.sdtw(q, r, device="cpu", **kwargs)


def test_soft_family_on_the_kernel_refuses_a_gradient(data):
    q, r = data
    spec = spec_for("local", reduction="softmin")
    qt = torch.from_numpy(q).requires_grad_()
    with pytest.raises(ValueError, match="backend='engine'"):
        repro_torch.sdtw(qt, r, spec=spec, backend="kernel", device="cpu")
    al = repro_torch.Aligner(r, spec=spec, backend="kernel", device="cpu")
    with pytest.raises(ValueError, match="backend='engine'"):
        al(qt)
    with torch.no_grad():                 # no graph wanted: K7 serves it
        assert repro_torch.sdtw(qt, r, spec=spec, backend="kernel",
                                device="cpu").cost.shape == (B,)
    cost = repro_torch.sdtw(qt, r, spec=spec, backend="engine",
                            device="cpu").cost
    cost.sum().backward()
    assert bool(torch.isfinite(qt.grad).all()) and bool(qt.grad.abs().sum())


def test_family_plan_errors(data):
    q, r = (torch.from_numpy(x) for x in data)
    lay = ops.prepare_reference(r, 2)
    for spec in (spec_for("twed"), spec_for("erp", reduction="softmin")):
        with pytest.raises(ValueError, match="runs the kernel in float32"):
            ops.sdtw_wavefront(q, r, segment_width=2, spec=spec,
                               compute_dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="no matched-window start"):
            ops.sdtw_wavefront(q, r, segment_width=2, spec=spec,
                               return_window=True)
        with pytest.raises(ValueError, match="reverse/checkpoint"):
            wavefront.check_plan(spec, reverse=True)
        with pytest.raises(ValueError, match="family specs run K7"):
            wavefront.wavefront(q, lay, n=N, w=2, spec=spec)
    with pytest.raises(ValueError, match="takes extra operands"):
        family.family_wavefront(q, lay, (), n=N, w=2, spec=spec_for("erp"))
    with pytest.raises(ValueError, match="family operand 'bl'"):
        family.family_wavefront(q, lay, (lay, lay), n=N, w=2,
                                spec=spec_for("erp"))


@pytest.mark.parametrize("spec,kwargs,message", [
    (DPSpec(), dict(kernel="soft"), "needs a softmin spec"),
    (DPSpec(reduction="softmin"), dict(kernel="hard"),
     "runs the soft wavefront"),
    (DPSpec(), dict(kernel="family"), "K7 runs the families"),
    (DPSpec(family="local"), dict(kernel="soft"), "family specs run K7"),
    (DPSpec(), dict(reverse=True), "hard-min plans have no reverse"),
    (DPSpec(reduction="softmin"), dict(checkpoint=True, with_window=True),
     "with_window needs a hard-min spec"),
    (DPSpec(), dict(checkpoint=True, with_window=True),
     "carry only the cost channel"),
    (DPSpec(distance="cosine"), dict(), "not 'cosine'"),
    (DPSpec(), dict(compute_dtype=torch.float16), "compute_dtype must be")])
def test_check_plan_rules(spec, kwargs, message):
    """The one place the kernel plans are checked, as
    ``repro.kernels.wavefront.KernelPlan.__post_init__``."""
    with pytest.raises(ValueError, match=message):
        wavefront.check_plan(spec, **kwargs)
    assert wavefront.plan_kernel(DPSpec(family="twed")) == "family"


@pytest.mark.parametrize("reduction", ["hardmin", "softmin"])
@pytest.mark.parametrize("family_", FAMS)
def test_device_t_diagonals_equal_int_t_diagonals(family_, reduction):
    """K7's plain sweep with the steady stretch run by the CUDA graph's
    body (the diagonal index a tensor, the reference windows through
    index_select, d1 / d2 rotating through fixed buffers), eagerly on the
    CPU, is bit-equal to the sweep with an int index everywhere, on a
    padded multi-chunk layout (folding j < n) and on a reference shorter
    than the query (no steady stretch)."""
    rng = np.random.default_rng(16)
    spec = spec_for(family_, reduction=reduction)
    for m, n in ((20, N3), (33, 30)):
        q = torch.from_numpy(rng.standard_normal((3, m)).astype(np.float32))
        r = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        lay = ops.prepare_reference(r, 2)
        ex = ops.family_extras(spec, q, r, segment_width=2)
        outs = [engine._dp_engine(q, lay, spec=spec, return_window=False,
                                  n_valid=n, extras=ex, _graph=graph)
                for graph in (False, True)]
        assert all(torch.equal(a, b) for a, b in zip(*outs))
        assert all(torch.equal(a, b) for a, b in zip(
            outs[0], family.family_plain(q, lay, ex, n=n, w=2, spec=spec)))


# ------------------------------------------------------ on the card
@pytest.mark.gpu
@pytest.mark.parametrize("reduction", ["hardmin", "softmin"])
@pytest.mark.parametrize("family_", FAMS)
def test_k7_matches_plain_on_card(cuda, family_, reduction):
    rng = np.random.default_rng(13)
    n = 2 * 1024 + 512 + 3           # three chunks at w = 32
    for m, band in ((33, None), (200, 64 if family_ == "local"
                                 else n - 200 + 37)):
        q = torch.from_numpy(rng.standard_normal((5, m)).astype(
            np.float32)).to(cuda)
        r = torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(cuda)
        for distance in ("sqeuclidean", "abs"):
            spec = spec_for(family_, distance, reduction, band)
            want = family.family_plain(
                q, ops.prepare_reference(r, 2),
                ops.family_extras(spec, q, r, segment_width=2), n=n, w=2,
                spec=spec)
            for w in wavefront.WIDTHS:
                before = family.counter.count
                got = family.family_wavefront(
                    q, ops.prepare_reference(r, w),
                    ops.family_extras(spec, q, r, segment_width=w), n=n,
                    w=w, spec=spec)
                torch.cuda.synchronize()
                assert family.counter.count == before + 1
                assert torch.equal(got[1], want[1])
                if reduction == "hardmin":
                    assert torch.equal(got[0], want[0])
                else:
                    torch.testing.assert_close(got[0], want[0], rtol=1e-4,
                                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("family_", FAMS)
def test_soft_k7_chunk_counts_on_card(cuda, family_, warps):
    """Soft K7's CTA of several warps at 1, P-1, P, P+1 and 2P+1 chunks
    (idle warps, a ring that wraps) against its plain version."""
    rng = np.random.default_rng(14)
    spec = spec_for(family_, reduction="softmin")
    P = wavefront.WARPS
    for m in (1, 33, 200):
        for k in (1, P - 1, P, P + 1, 2 * P + 1):
            n = (k - 1) * 64 + 35            # w = 2: 64 columns a chunk
            q = torch.from_numpy(rng.standard_normal((3, m)).astype(
                np.float32)).to(cuda)
            r = torch.from_numpy(rng.standard_normal(n).astype(
                np.float32)).to(cuda)
            lay = ops.prepare_reference(r, 2)
            ex = ops.family_extras(spec, q, r, segment_width=2)
            want = family.family_plain(q, lay, ex, n=n, w=2, spec=spec)
            got = family.family_cuda(q, lay, ex, n=n, w=2, spec=spec,
                                     warps=warps)
            torch.cuda.synchronize()
            assert torch.equal(got[1], want[1]), (m, k)
            torch.testing.assert_close(got[0], want[0], rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("family_", FAMS)
def test_soft_k7_at_its_longest_query_on_card(cuda, family_):
    """The longest query soft K7 takes at 8 warps (its dynamic and static
    shared memory together at the block's limit) against its plain
    version."""
    rng = np.random.default_rng(15)
    spec = spec_for(family_, reduction="softmin")
    m, n = 26_912, 100
    q = torch.from_numpy(rng.standard_normal((2, m)).astype(
        np.float32)).to(cuda)
    r = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    lay = ops.prepare_reference(r, 2)
    ex = ops.family_extras(spec, q, r, segment_width=2)
    want = family.family_plain(q, lay, ex, n=n, w=2, spec=spec)
    got = family.family_cuda(q, lay, ex, n=n, w=2, spec=spec)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("family_", FAMS)
def test_hard_k7_chunk_counts_on_card(cuda, family_, warps):
    """Hard K7's CTA of several warps at 1, P-1, P, P+1 and 2P+1 chunks
    (idle warps, a ring that wraps), bit-equal to its plain version."""
    rng = np.random.default_rng(17)
    spec = spec_for(family_)
    P = wavefront.WARPS
    for m in (1, 33, 200):
        for k in (1, P - 1, P, P + 1, 2 * P + 1):
            n = (k - 1) * 64 + 35            # w = 2: 64 columns a chunk
            q = torch.from_numpy(rng.standard_normal((3, m)).astype(
                np.float32)).to(cuda)
            r = torch.from_numpy(rng.standard_normal(n).astype(
                np.float32)).to(cuda)
            lay = ops.prepare_reference(r, 2)
            ex = ops.family_extras(spec, q, r, segment_width=2)
            want = family.family_plain(q, lay, ex, n=n, w=2, spec=spec)
            got = family.family_cuda(q, lay, ex, n=n, w=2, spec=spec,
                                     warps=warps)
            torch.cuda.synchronize()
            assert torch.equal(got[1], want[1]), (m, k)
            assert torch.equal(got[0], want[0]), (m, k)


@pytest.mark.gpu
@pytest.mark.parametrize("family_", FAMS)
def test_hard_k7_at_its_longest_query_on_card(cuda, family_):
    """The longest query hard K7 takes at 8 warps (the soft build's
    geometry), bit-equal to its plain version."""
    rng = np.random.default_rng(18)
    spec = spec_for(family_)
    m, n = 26_912, 100
    assert wavefront.longest_query(spec) == m
    q = torch.from_numpy(rng.standard_normal((2, m)).astype(
        np.float32)).to(cuda)
    r = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    lay = ops.prepare_reference(r, 2)
    ex = ops.family_extras(spec, q, r, segment_width=2)
    want = family.family_plain(q, lay, ex, n=n, w=2, spec=spec)
    got = family.family_cuda(q, lay, ex, n=n, w=2, spec=spec)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("reduction", ["hardmin", "softmin"])
@pytest.mark.parametrize("family_", FAMS)
def test_plain_graph_sweep_equals_eager_on_card(cuda, family_, reduction):
    """K7's plain sweep with its steady stretch replayed from a CUDA graph
    is bit-equal to the eager sweep on the card."""
    rng = np.random.default_rng(19)
    spec = spec_for(family_, reduction=reduction)
    m, n = 40, 700
    q = torch.from_numpy(rng.standard_normal((4, m)).astype(
        np.float32)).to(cuda)
    r = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    lay = ops.prepare_reference(r, 2)
    ex = ops.family_extras(spec, q, r, segment_width=2)
    outs = [engine._dp_engine(q, lay, spec=spec, return_window=False,
                              n_valid=n, extras=ex, _graph=graph)
            for graph in (False, True)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.gpu
@pytest.mark.parametrize("family_", FAMS)
def test_plain_graph_sweep_on_a_card_not_current(cuda, family_):
    """The graph sweep on a tensor of a card that is not the current one
    captures and replays on that tensor's card: bit-equal to the eager
    sweep there, and the current card stays current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    rng = np.random.default_rng(23)
    spec = spec_for(family_)
    other = torch.device("cuda", 1)
    q = torch.from_numpy(rng.standard_normal((4, 40)).astype(
        np.float32)).to(other)
    r = torch.from_numpy(rng.standard_normal(700).astype(np.float32)).to(
        other)
    lay = ops.prepare_reference(r, 2)
    ex = ops.family_extras(spec, q, r, segment_width=2)
    with torch.cuda.device(0):
        outs = [engine._dp_engine(q, lay, spec=spec, return_window=False,
                                  n_valid=700, extras=ex, _graph=graph)
                for graph in (False, True)]
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(other)
    assert all(x.device == other for x in outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
