"""The port's sweep (K1/K3/K4 plain version, engine, row-scan ref) against
the JAX package's ref and engine, the float64 oracle, and the Pallas
kernel in interpret mode where this JAX can trace it; on the card, the
CUDA wavefront against its plain version, bit for bit."""
import types

import numpy as np
import pytest
import torch

from repro_torch.core.engine import sdtw_engine
from repro_torch.core.ref import sdtw_numpy as port_numpy, sdtw_ref
from repro_torch.core.spec import DPSpec, NO_WINDOW
from repro_torch.kernels import ops, wavefront

TOL = dict(rtol=2e-3, atol=2e-3)     # what repro holds its own kernel to
BIG_BAND = 10_000
N3 = 2 * 64 + 22      # spans 3 port chunks at w=2 (64 columns each)

# (m, n, w, batch, distance, band): every value of each axis appears,
# and m x n, m x band, w x band pairs are spread across the cases
CASES = [
    (4, 64, 2, 1, "sqeuclidean", None),
    (4, 200, 8, 3, "abs", 0),
    (4, 1000, 14, 9, "sqeuclidean", 5),
    (4, N3, 2, 3, "sqeuclidean", BIG_BAND),
    (33, 64, 14, 3, "sqeuclidean", None),
    (33, 200, 2, 9, "sqeuclidean", 5),
    (33, 1000, 8, 1, "abs", None),
    (33, N3, 2, 1, "abs", 0),
    (33, N3, 8, 9, "sqeuclidean", BIG_BAND),
    (64, 64, 8, 9, "abs", 5),
    (64, 200, 14, 1, "sqeuclidean", 0),
    (64, 1000, 2, 3, "sqeuclidean", None),
    (64, N3, 14, 3, "abs", BIG_BAND),
    (64, 1000, 8, 3, "abs", 5),
    (33, 1000, 14, 9, "sqeuclidean", 0),
    (64, 40, 8, 3, "sqeuclidean", 5),          # blocked band
]


@pytest.fixture
def jx():
    """The JAX side of a parity test, imported here so the card-only
    tests of this file also run where JAX is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.engine import sdtw_engine
    from repro.core.ref import sdtw_numpy, sdtw_ref
    from repro.core.spec import DPSpec

    def engine(q, r, spec=None):
        return _np(*sdtw_engine(jnp.asarray(q), jnp.asarray(r), spec=spec,
                                return_window=True))

    def ref(q, r, spec=None, **kw):
        return _np(*sdtw_ref(jnp.asarray(q), jnp.asarray(r), spec, **kw))

    return types.SimpleNamespace(engine=engine, ref=ref, Spec=DPSpec,
                                 numpy=sdtw_numpy, jnp=jnp)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest -m gpu` on the H100")
    return torch.device("cuda")


def _inputs(b, m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, m)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32))


def _np(*xs):
    return [np.asarray(x) for x in xs]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_wavefront_and_engine_match_jax(jx, case):
    m, n, w, b, distance, band = case
    q, r = _inputs(b, m, n, seed=m * 7 + n)
    spec = DPSpec(distance=distance, band=band)
    jc, js, je = jx.engine(q, r, jx.Spec(distance=distance, band=band))
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    for window in (False, True):
        outs = {
            "wavefront": ops.sdtw_wavefront(qt, rt, segment_width=w,
                                            spec=spec, return_window=window),
            "engine": sdtw_engine(qt, rt, spec=spec, return_window=window),
        }
        for name, out in outs.items():
            cost, end = out[0].numpy(), out[-1].numpy()
            np.testing.assert_allclose(cost, jc, **TOL, err_msg=name)
            np.testing.assert_array_equal(end, je, err_msg=name)
            if window:
                np.testing.assert_array_equal(out[1].numpy(), js,
                                              err_msg=name)
    if ops.band_blocked(m, n, band):
        assert np.isinf(jc).all() and (je == 0).all()
        assert (js == NO_WINDOW).all()


@pytest.mark.parametrize("case", [c for c in CASES if c[0] <= 33
                                  and c[1] <= 200],
                         ids=lambda c: "-".join(map(str, c)))
def test_port_ref_matches_jax_ref(jx, case):
    m, n, w, b, distance, band = case
    q, r = _inputs(b, m, n, seed=m + n)
    jc, js, je = jx.ref(q, r, jx.Spec(distance=distance, band=band),
                        return_window=True)
    spec = DPSpec(distance=distance, band=band)
    c, s, e = sdtw_ref(torch.from_numpy(q), torch.from_numpy(r), spec,
                       return_window=True)
    np.testing.assert_allclose(c.numpy(), jc, **TOL)
    np.testing.assert_array_equal(e.numpy(), je)
    np.testing.assert_array_equal(s.numpy(), js)
    # and the kernel's plain version agrees with the port's own oracle
    kc, ks, ke = ops.sdtw_wavefront(torch.from_numpy(q), torch.from_numpy(r),
                                    segment_width=w, spec=spec,
                                    return_window=True)
    np.testing.assert_allclose(kc.numpy(), c.numpy(), **TOL)
    np.testing.assert_array_equal(ke.numpy(), e.numpy())
    np.testing.assert_array_equal(ks.numpy(), s.numpy())


@pytest.mark.parametrize("distance,band", [("sqeuclidean", None),
                                           ("abs", 3), ("sqeuclidean", 0)])
def test_float64_oracle(jx, distance, band):
    q, r = _inputs(3, 12, 90, seed=5)
    spec = DPSpec(distance=distance, band=band)
    jspec = jx.Spec(distance=distance, band=band)
    c, e = ops.sdtw_wavefront(torch.from_numpy(q), torch.from_numpy(r),
                              segment_width=2, spec=spec)
    for i in range(3):
        want = port_numpy(q[i], r, spec)
        assert want == jx.numpy(q[i], r, jspec)         # the copy is exact
        np.testing.assert_allclose(float(c[i]), want[0], **TOL)
        assert int(e[i]) == want[1]


def test_planted_exact_submatch(jx):
    q, r = _inputs(1, 40, 1000, seed=11)
    r[300:340] = q[0]
    c, s, e = ops.sdtw_wavefront(torch.from_numpy(q), torch.from_numpy(r),
                                 segment_width=8, return_window=True)
    assert (float(c[0]), int(s[0]), int(e[0])) == (0.0, 300, 339)
    jc, js, je = jx.engine(q, r)
    assert (float(jc[0]), int(js[0]), int(je[0])) == (0.0, 300, 339)


def test_exact_tie_earliest_column_wins(jx):
    """Two exact copies of the query: both windows cost exactly 0 and the
    earliest column wins, as in the JAX row-scan ref.  At w=2 the later
    end (129) sits on lane 0 of chunk 2 and the earlier (59) on lane 29
    of chunk 0, so a lowest-lane rule would report 129."""
    q, r = _inputs(1, 10, 200, seed=3)
    r[50:60] = q[0]
    r[120:130] = q[0]
    jc, je = jx.ref(q, r)
    assert (float(jc[0]), int(je[0])) == (0.0, 59)
    for w in (2, 8):
        c, s, e = ops.sdtw_wavefront(torch.from_numpy(q), torch.from_numpy(r),
                                     segment_width=w, return_window=True)
        assert (float(c[0]), int(s[0]), int(e[0])) == (0.0, 50, 59)


def test_pallas_interpret_kernel(jx):
    """The JAX Pallas wavefront in interpret mode, where this JAX can
    trace it (it needs ``jax.experimental.pallas.load``)."""
    from jax.experimental import pallas as pl
    if not hasattr(pl, "load"):
        pytest.skip("this JAX's pallas has no `load`: the Pallas wavefront "
                    "does not trace here")
    from repro.kernels import ops as jax_ops
    for m, n, w in [(16, 128, 4), (33, 200, 2)]:
        q, r = _inputs(4, m, n, seed=m)
        jc, je = _np(*jax_ops.sdtw_wavefront(jx.jnp.asarray(q),
                                             jx.jnp.asarray(r),
                                             segment_width=w, interpret=True))
        c, e = ops.sdtw_wavefront(torch.from_numpy(q), torch.from_numpy(r),
                                  segment_width=w)
        np.testing.assert_allclose(c.numpy(), jc, **TOL)
        np.testing.assert_array_equal(e.numpy(), je)


def test_geometry():
    assert wavefront.band_grid_chunks(4, 5, 3, 14) == 1
    assert wavefront.band_grid_chunks(33, None, 4, 2) == 4
    assert wavefront.band_grid_chunks(2000, 900, 47, 2) == 46
    lay = ops.prepare_reference(torch.arange(150.0), 2)
    assert lay.shape == (192,) and float(lay[150:].abs().sum()) == 0.0
    assert ops.width_candidates(100) == (2, 4, 8)
    assert ops.width_candidates(20) == (2,)
    assert ops.width_candidates(100_000) == ops.DEFAULT_WIDTH_CANDIDATES
    with pytest.raises(ValueError, match="does not match segment_width"):
        ops.sdtw_wavefront_prepped(torch.zeros(2, 5), lay, n=150,
                                   segment_width=8)
    with pytest.raises(ValueError, match="does not fit the layout"):
        ops.sdtw_wavefront_prepped(torch.zeros(2, 5), lay, n=100,
                                   segment_width=2)


@pytest.mark.gpu
@pytest.mark.parametrize("b,m,n", [(1, 33, 50), (9, 33, 3000),
                                   (64, 2000, 3000)])
@pytest.mark.parametrize("band", [None, 0, 64, 900])
@pytest.mark.parametrize("window", [False, True])
def test_kernel_bit_equal_to_plain_on_card(cuda, b, m, n, band, window):
    q, r = (torch.from_numpy(x).to(cuda) for x in _inputs(b, m, n, seed=1))
    spec = DPSpec(band=band)
    want = wavefront.wavefront_plain(q, wavefront.prepare_reference(r, 2),
                                     n=n, w=2, spec=spec,
                                     with_window=window)
    for w in wavefront.WIDTHS:
        before = wavefront.counter.count
        got = wavefront.wavefront(q, wavefront.prepare_reference(r, w), n=n,
                                  w=w, spec=spec, with_window=window)
        torch.cuda.synchronize()
        assert wavefront.counter.count == before + 1
        for a, b_ in zip(got, want):
            assert torch.equal(a, b_), (w, a[:4], b_[:4])


def chunk_count_lengths(w, warps=wavefront.WARPS):
    """Reference lengths giving 1, P-1, P, P+1 and 2P+1 chunks of
    ``32 * w`` columns (P warps per CTA), each last chunk partly pad."""
    W = wavefront.chunk_cols(w)
    return [(k - 1) * W + W // 2 + 3
            for k in (1, warps - 1, warps, warps + 1, 2 * warps + 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 33])
@pytest.mark.parametrize("window", [False, True])
def test_kernel_bit_equal_at_every_chunk_count_on_card(cuda, m, window):
    """Chunks fewer than, equal to and one more than the warps of a CTA,
    and 2P+1: idle warps, a ring that wraps, m below one ring group."""
    for w in wavefront.WIDTHS:
        for n in chunk_count_lengths(w):
            q, r = (torch.from_numpy(x).to(cuda)
                    for x in _inputs(3, m, n, seed=n))
            lay = wavefront.prepare_reference(r, w)
            want = wavefront.wavefront_plain(q, lay, n=n, w=w, spec=DPSpec(),
                                             with_window=window)
            got = wavefront.wavefront(q, lay, n=n, w=w, spec=DPSpec(),
                                      with_window=window)
            torch.cuda.synchronize()
            for a, b_ in zip(got, want):
                assert torch.equal(a, b_), (w, n, a[:3], b_[:3])


@pytest.mark.gpu
def test_kernel_at_its_longest_query_on_card(cuda):
    """The longest query the hard-min kernel takes: its dynamic and
    static shared memory together at the block's limit."""
    m, n = 26_912, 100
    q, r = (torch.from_numpy(x).to(cuda) for x in _inputs(2, m, n, seed=5))
    lay = wavefront.prepare_reference(r, 2)
    want = wavefront.wavefront_plain(q, lay, n=n, w=2, spec=DPSpec())
    got = wavefront.wavefront(q, lay, n=n, w=2, spec=DPSpec())
    torch.cuda.synchronize()
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.gpu
def test_exact_tie_on_card(cuda):
    q, r = _inputs(1, 10, 200, seed=3)
    r[50:60] = q[0]
    r[120:130] = q[0]
    c, s, e = ops.sdtw_wavefront(torch.from_numpy(q).to(cuda),
                                 torch.from_numpy(r).to(cuda),
                                 segment_width=2, return_window=True)
    assert (float(c[0]), int(s[0]), int(e[0])) == (0.0, 50, 59)



@pytest.mark.gpu
@pytest.mark.parametrize("gamma", [None, 1.0])
def test_front_door_runs_past_the_kernels_longest_query_on_card(cuda,
                                                               gamma):
    """A 30,000-sample query is longer than any kernel plan launches:
    repro_torch.sdtw and an Aligner that chose their backend run it on
    the engine (no kernel launch), equal to backend="engine"; a named
    kernel backend raises its shaped error."""
    import repro_torch
    kw = {} if gamma is None else dict(reduction="softmin", gamma=gamma)
    q, r = _inputs(2, 30_000, 300, seed=30)
    want = repro_torch.sdtw(q, r, backend="engine", **kw)
    launches = (wavefront.counter.count, wavefront.soft_counter.count)
    got = [repro_torch.sdtw(q, r, **kw), repro_torch.Aligner(r, **kw)(q)]
    torch.cuda.synchronize()
    assert (wavefront.counter.count,
            wavefront.soft_counter.count) == launches
    for res in got:
        assert res.cost.device.type == "cuda"
        assert torch.equal(res.cost, want.cost)
        assert torch.equal(res.end, want.end)
    assert bool(torch.isfinite(want.cost).all())
    with pytest.raises(ValueError, match="bytes of shared memory"):
        repro_torch.sdtw(q, r, backend="kernel", **kw)
