"""Soft-min sDTW in the port (ref, engine, the K5 wrapper's plain
version, the front door, Aligner, soft alignment) against the JAX
package's soft-min ref, engine, front door and ``align.soft``, and the
float64 oracle; on the card, K5 and K6 against their plain versions."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.align import soft as port_soft
from repro_torch.core.engine import sdtw_engine
from repro_torch.core.ref import sdtw_numpy as port_numpy, sdtw_ref
from repro_torch.core.spec import SOFT_BIG, DPSpec
from repro_torch.kernels import ops, wavefront

TOL = dict(rtol=1e-4, atol=1e-4)   # what repro holds its soft kernel to
N3 = 2 * 64 + 22                   # 3 port chunks at w=2, pad tail 42
GAMMAS = (0.01, 0.1, 1.0)
BANDS = (None, 0, 40)


def _soft(gamma, band=None, distance="sqeuclidean"):
    return DPSpec(reduction="softmin", gamma=gamma, band=band,
                  distance=distance)


@pytest.fixture
def jx():
    """The JAX side, imported here so the card-only tests of this file
    also run where JAX is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro
    from repro.align import soft as jax_soft
    from repro.core.engine import sdtw_engine as jax_engine
    from repro.core.ref import sdtw_numpy, sdtw_ref as jax_ref
    from repro.core.spec import DPSpec as JaxSpec

    def spec(gamma, band=None, distance="sqeuclidean"):
        return JaxSpec(reduction="softmin", gamma=gamma, band=band,
                       distance=distance)

    def engine(q, r, s):
        return [np.asarray(x) for x in jax_engine(jnp.asarray(q),
                                                  jnp.asarray(r), spec=s)]

    def ref(q, r, s):
        return [np.asarray(x) for x in jax_ref(jnp.asarray(q),
                                               jnp.asarray(r), s)]

    return types.SimpleNamespace(spec=spec, engine=engine, ref=ref,
                                 numpy=sdtw_numpy, soft=jax_soft,
                                 repro=repro, jnp=jnp)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest -m gpu` on the H100")
    return torch.device("cuda")


def _inputs(b, m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, m)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32))


@pytest.mark.parametrize("gamma", GAMMAS)
@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("distance", ["sqeuclidean", "abs"])
def test_engine_and_k5_plain_match_jax(jx, gamma, band, distance):
    q, r = _inputs(3, 20, N3, seed=int(gamma * 100) + (band or 1))
    jc, je = jx.engine(q, r, jx.spec(gamma, band, distance))
    spec = _soft(gamma, band, distance)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    for w in (2, 8):
        outs = {"engine": sdtw_engine(qt, rt, spec=spec),
                "k5": ops.sdtw_wavefront(qt, rt, segment_width=w,
                                         spec=spec)}
        for name, (c, e) in outs.items():
            np.testing.assert_allclose(c.numpy(), jc, **TOL, err_msg=name)
            np.testing.assert_array_equal(e.numpy(), je, err_msg=name)


@pytest.mark.parametrize("gamma,band", [(0.01, None), (0.1, 0), (1.0, 5)])
def test_port_ref_matches_jax_ref_and_oracle(jx, gamma, band):
    q, r = _inputs(2, 9, 70, seed=4)
    jc, je = jx.ref(q, r, jx.spec(gamma, band))
    c, e = sdtw_ref(torch.from_numpy(q), torch.from_numpy(r),
                    _soft(gamma, band))
    np.testing.assert_allclose(c.numpy(), jc, **TOL)
    np.testing.assert_array_equal(e.numpy(), je)
    for i in range(2):
        want = port_numpy(q[i], r, _soft(gamma, band))
        assert want == jx.numpy(q[i], r, jx.spec(gamma, band))  # exact copy
        np.testing.assert_allclose(float(c[i]), want[0], **TOL)
        assert int(e[i]) == want[1]


def test_tiny_gamma_held_to_the_float64_oracle(jx):
    """gamma = 1e-3, where the JAX package's own gamma -> 0 property test
    can fail: the port's engine and K5 plain version are held to the
    float64 soft oracle, which is within 1e-2 of the hard cost."""
    q, r = _inputs(3, 10, 120, seed=9)
    spec = _soft(1e-3)
    c, e = sdtw_engine(torch.from_numpy(q), torch.from_numpy(r), spec=spec)
    k, ke = ops.sdtw_wavefront(torch.from_numpy(q), torch.from_numpy(r),
                               segment_width=2, spec=spec)
    for i in range(3):
        want, end = port_numpy(q[i], r, spec)
        hard, _ = port_numpy(q[i], r)
        np.testing.assert_allclose([float(c[i]), float(k[i])], want, **TOL)
        assert int(e[i]) == end == int(ke[i])
        assert abs(want - hard) < 1e-2


def test_spec_soft_fields(jx):
    spec = _soft(0.25, 3)
    assert spec.soft and spec.big == SOFT_BIG and not DPSpec().soft
    assert spec.describe() == jx.spec(0.25, 3).describe()
    with pytest.raises(ValueError, match="gamma > 0"):
        _soft(0.0)
    rng = np.random.default_rng(2)
    a, b, c = (rng.normal(size=5).astype(np.float32) * 3 for _ in range(3))
    a[0] = b[0] = c[0] = SOFT_BIG       # every operand blocked: finite
    b[1] = SOFT_BIG
    port, js = _soft(0.3), jx.spec(0.3)
    got3 = port.reduce3(*map(torch.from_numpy, (a, b, c))).numpy()
    assert np.isfinite(got3).all()
    np.testing.assert_allclose(got3, np.asarray(js.reduce3(a, b, c)),
                               rtol=1e-6)


@pytest.mark.parametrize("backend", ["kernel", "engine", "ref", "soft"])
def test_front_door_matches_repro(jx, backend):
    q, r = _inputs(3, 12, 180, seed=5)
    q = q * 2 + 1
    want = jx.repro.sdtw(q, r, gamma=0.5, backend="engine")
    got = repro_torch.sdtw(q, r, gamma=0.5, backend=backend,
                           segment_width=2, device="cpu")
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               **TOL)
    np.testing.assert_array_equal(got.end.numpy(), np.asarray(want.end))


def test_soft_alias_forces_softmin(jx):
    q, r = _inputs(2, 8, 60, seed=6)
    got = repro_torch.sdtw(q, r, backend="soft", device="cpu")
    want = jx.repro.sdtw(q, r, backend="soft")
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               **TOL)
    al = repro_torch.Aligner(r, backend="soft", device="cpu")
    assert al.spec.soft and al.backend.name == "engine"


@pytest.mark.parametrize("backend", ["kernel", "engine"])
def test_aligner_matches_jax_session(jx, backend):
    q, r = _inputs(4, 16, 300, seed=8)
    jal = jx.repro.Aligner(r, gamma=0.1, band=30, backend="engine")
    want = jal(q)
    spec_dict = dataclasses.asdict(jal.spec)
    al = convert.aligner_from_numpy(np.asarray(jal.reference), spec_dict,
                                    device="cpu", backend=backend,
                                    segment_width=4)
    assert al.spec.soft and al.spec.gamma == 0.1
    from repro.core.normalize import normalize_batch
    got = al(np.asarray(normalize_batch(q)))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               **TOL)
    np.testing.assert_array_equal(got.end.numpy(), np.asarray(want.end))


@pytest.mark.parametrize("backend", ["kernel", "engine"])
@pytest.mark.parametrize("band", [None, 40])
def test_soft_alignment_matches_repro(jx, backend, band):
    q, r = _inputs(2, 10, 300, seed=12)
    spec = _soft(0.5, band)
    want = np.asarray(jx.soft.expected_alignment(
        q, r, spec=jx.spec(0.5, band)))
    got = repro_torch.sdtw(q, r, spec=spec, backend=backend, device="cpu",
                           segment_width=2,
                           outputs=("cost", "soft_alignment"))
    np.testing.assert_allclose(got.soft_alignment.numpy(), want, **TOL)
    assert got.present == {"cost", "soft_alignment"}
    E = port_soft.expected_alignment(q, r, spec=spec, backend=backend,
                                     device="cpu", segment_width=2)
    np.testing.assert_allclose(E.numpy(), want, **TOL)
    dist = port_soft.row_position_distribution(E)
    np.testing.assert_allclose(dist.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(
        dist.numpy(), np.asarray(jx.soft.row_position_distribution(want)),
        **TOL)
    assert (E.sum(-1).numpy() >= 1 - 1e-4).all()


def test_aligner_soft_alignment_reuses_layouts(jx):
    q, r = _inputs(3, 10, 200, seed=13)
    al = repro_torch.Aligner(r, gamma=0.5, backend="kernel", device="cpu",
                             segment_width=2)
    first = al(q, outputs=("soft_alignment",))
    second = al(q, outputs=("cost", "end", "soft_alignment"))
    assert al.stats.layout_builds == 2           # forward + reverse, once
    assert first.present == {"soft_alignment"}
    assert torch.equal(first.soft_alignment, second.soft_alignment)
    want = np.asarray(jx.soft.expected_alignment(q, r, spec=jx.spec(0.5)))
    np.testing.assert_allclose(second.soft_alignment.numpy(), want, **TOL)
    from repro.core.normalize import normalize_batch
    jc, je = jx.engine(np.asarray(normalize_batch(q)),
                       np.asarray(al.reference), jx.spec(0.5))
    np.testing.assert_allclose(second.cost.numpy(), jc, **TOL)


def test_soft_costs_promotes_to_softmin(jx):
    q, r = _inputs(2, 8, 90, seed=14)
    c, e = port_soft.soft_costs(q, r, spec=DPSpec(gamma=0.2), device="cpu")
    jc, je = jx.soft.soft_costs(q, r, spec=jx.repro.DPSpec(gamma=0.2))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


@pytest.mark.parametrize("backend", ["kernel", "engine", "ref"])
def test_blocked_band_inf_cost_zero_alignment(jx, backend):
    q, r = _inputs(2, 30, 12, seed=15)        # m - 1 - band > n - 1
    spec = _soft(0.5, 2)
    jc, _ = jx.engine(q, r, jx.spec(0.5, 2))
    assert np.isinf(jc).all()
    outputs = ("cost", "end") if backend == "ref" else \
        ("cost", "end", "soft_alignment")
    got = repro_torch.sdtw(q, r, spec=spec, backend=backend, device="cpu",
                           segment_width=2, outputs=outputs)
    assert torch.isinf(got.cost).all() and (got.end == 0).all()
    if backend != "ref":
        assert float(got.soft_alignment.abs().sum()) == 0.0


@pytest.mark.parametrize("outputs,match", [
    (("cost", "start"), "under soft-min"),
    (("soft_alignment",), None),
])
def test_soft_capabilities(outputs, match):
    q, r = _inputs(2, 8, 40, seed=16)
    if match is None:
        res = repro_torch.sdtw(q, r, gamma=0.5, outputs=outputs,
                               device="cpu")
        assert res.present == frozenset(outputs)
        return
    with pytest.raises(ValueError, match=match):
        repro_torch.sdtw(q, r, gamma=0.5, outputs=outputs, device="cpu",
                         backend="kernel")


# ------------------------------------------------------------- the card
@pytest.mark.gpu
@pytest.mark.parametrize("gamma,band,distance", [
    (0.01, None, "sqeuclidean"), (0.1, 0, "abs"), (1.0, 64, "sqeuclidean"),
    (1.0, None, "abs"), (0.1, 900, "abs")])
def test_k5_and_k6_match_plain_on_card(cuda, gamma, band, distance):
    spec = _soft(gamma, band, distance)
    for w in wavefront.WIDTHS:
        W = wavefront.chunk_cols(w)
        n = 2 * W + W // 2 + 3
        q, r = (torch.from_numpy(x).to(cuda)
                for x in _inputs(9, 200, n, seed=w))
        lay = ops.prepare_reference(r, w)
        rlay = ops.prepare_reference_reverse(r, w)
        qf = torch.flip(q, (1,)).contiguous()
        pairs = [
            (wavefront.soft_wavefront(q, lay, n=n, w=w, spec=spec),
             wavefront.soft_plain(q, lay, n=n, w=w, spec=spec)),
            (wavefront.soft_checkpoint(q, lay, n=n, w=w, spec=spec),
             wavefront.checkpoint_plain(q, lay, n=n, w=w, spec=spec)),
            (wavefront.soft_checkpoint(qf, rlay, n=n, w=w, spec=spec,
                                       reverse=True),
             wavefront.checkpoint_plain(qf, rlay, n=n, w=w, spec=spec,
                                        reverse=True))]
        torch.cuda.synchronize()
        for k, (got, want) in enumerate(pairs):
            torch.testing.assert_close(got[0], want[0], **TOL)
            if k < 2:
                assert torch.equal(got[1], want[1])
            if k:
                torch.testing.assert_close(got[2], want[2], **TOL)
        torch.testing.assert_close(pairs[2][0][0], pairs[1][0][0],
                                   rtol=1e-5, atol=1e-5)
