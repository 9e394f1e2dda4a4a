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


# ------------------------------------------- the soft kernel, emulated
def _kernel_sweep(q, lay, *, n, w, spec, reverse=False,
                  warps=wavefront.WARPS):
    """K5 / the K6 pair of ``csrc/wavefront.cu`` emulated in float32
    numpy: its base-2 soft-min cell (arguments pre-scaled by
    log2(e)/gamma, the min's own term fixed at 1, the logarithm in base 2
    times gamma * ln 2; numpy's exp2 / log2 stand in for MUFU ex2 / lg2),
    its boundary rules, each lane's folds over its bottom-row cells
    (visited chunk c on warp c mod P, lane l owning columns l*w .. l*w +
    w - 1 of it), their merge (the shuffle tree within a warp, then the
    warps in turn) and the readout of the minimum itself beside the
    base-2 soft correction.  Returns (cost, end, strips, bottom row)."""
    f32 = np.float32
    B, m = q.shape
    chunk0, chunks, jlim, shift = wavefront.soft_geometry(
        m, n, lay.shape[0], w, spec.band, reverse)
    W = wavefront.chunk_cols(w)
    cols = np.arange(chunk0 * W, (chunk0 + chunks) * W)
    r = lay[cols]
    k2 = f32(np.log2(np.e) / spec.gamma)
    gl = f32(spec.gamma * np.log(2.0))
    big = f32(SOFT_BIG)

    def smin3(a, b, c):
        lo, hi = np.minimum(b, c), np.maximum(b, c)
        mn, o2 = np.minimum(a, lo), np.maximum(a, lo)
        s = f32(1) + np.exp2((mn - hi) * k2) + np.exp2((mn - o2) * k2)
        return mn - gl * np.log2(s)

    D = np.full((B, m, cols.size), big, f32)
    for i in range(m):
        for x, j in enumerate(cols):
            d = q[:, i] - r[x]
            cst = np.abs(d) if spec.distance == "abs" else d * d
            left = D[:, i, x - 1] if x else np.full(B, big, f32)
            up = D[:, i - 1, x] if i else np.full(B, big, f32)
            ul = D[:, i - 1, x - 1] if i and x else np.full(B, big, f32)
            if reverse:
                val = cst + smin3(left if i < m - 1 else big,
                                  up if i else big, ul if i else f32(0))
                if j < jlim:
                    val = np.full(B, big, f32)
            else:
                val = cst if i == 0 else cst + smin3(left, up, ul)
            if spec.band is not None and abs(i - j - shift) > spec.band:
                val = np.full(B, big, f32)
            D[:, i, x] = val
    folds = {}                     # (warp, lane) -> its columns' indices
    for x, j in enumerate(cols):
        foldable = j >= jlim if reverse else j < jlim
        if spec.band is not None and abs(m - 1 - j - shift) > spec.band:
            foldable = False
        c = j // W - chunk0
        key = (c % warps, (j % W) // w)
        folds.setdefault(key, [])
        if foldable:
            folds[key].append(x)

    def lane_fold(b, xs):
        best_v, best_j = big, 0
        run_m, run_s = -big, f32(0)
        for x in xs:                          # ascending columns
            v = D[b, m - 1, x]
            if v < best_v:
                best_v, best_j = v, int(cols[x])
            xv = -v * k2
            dd = xv - run_m
            e = np.exp2(-np.abs(dd))
            run_s = run_s * e + f32(1) if dd > 0 else run_s + e
            run_m = max(run_m, xv)
        return best_v, best_j, run_m, run_s

    def merge(a, o):
        (av, aj, am, as_), (ov, oj, om, os_) = a, o
        if ov < av or (ov == av and oj < aj):
            av, aj = ov, oj
        mx = max(am, om)
        return av, aj, mx, as_ * np.exp2(am - mx) + os_ * np.exp2(om - mx)

    cost, end = np.empty(B, f32), np.empty(B, np.int32)
    for b in range(B):
        total = None
        for p in range(warps):
            f = [lane_fold(b, folds.get((p, lane), [])) for lane in range(32)]
            for off in (16, 8, 4, 2, 1):      # __shfl_down_sync
                f = [merge(f[x], f[x + off]) if x + off < 32 else f[x]
                     for x in range(32)]
            total = f[0] if total is None else merge(total, f[0])
        bv, bj, rm, rs = total          # the minimum read out exactly
        cost[b] = np.inf if bv >= big / 2 \
            else bv - gl * (np.log2(rs) + (rm + bv * k2))
        end[b] = bj
    strips = np.stack([np.full((B, m), big, f32) if c == 0
                       else D[:, :, c * W - 1] for c in range(chunks)], 1)
    return cost, end, strips, D[:, m - 1]


def _tie_inputs():
    """A reference holding one query's window twice, ending in visited
    chunks 0 and 1 at w 2 (warps 0 and 1): at gamma 1e-3 both bottom-row
    cells are exactly 0, the minimum."""
    q, r = _inputs(3, 20, 3 * 64 - 20, seed=41)
    r[80:100] = r[10:30]
    q[1] = r[10:30]
    return q, r


@pytest.mark.parametrize("case", ["unbanded", "banded", "abs",
                                  "tie_across_warps", "blocked_band"])
def test_emulated_kernel_sweep_matches_plain_and_jax(jx, case):
    w = 2
    gamma, band, distance = {
        "unbanded": (0.7, None, "sqeuclidean"), "banded": (0.1, 30, "abs"),
        "abs": (1.0, None, "abs"),
        "tie_across_warps": (1e-3, None, "sqeuclidean"),
        "blocked_band": (0.5, 5, "sqeuclidean")}[case]
    if case == "tie_across_warps":
        q, r = _tie_inputs()
    elif case == "blocked_band":
        q, r = _inputs(3, 20, 10, seed=42)      # m - 1 - band > n - 1
    else:
        q, r = _inputs(3, 20, 3 * 64 - 20, seed=43)
    n = r.shape[0]
    spec = _soft(gamma, band, distance)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    lay = ops.prepare_reference(rt, w)
    cost, end, strips, bottom = _kernel_sweep(q, lay.numpy(), n=n, w=w,
                                              spec=spec)
    pc, pe = wavefront.soft_plain(qt, lay, n=n, w=w, spec=spec)
    jc, je = jx.engine(q, r, jx.spec(gamma, band, distance))
    for want_c, want_e in ((pc.numpy(), pe.numpy()), (jc, je)):
        np.testing.assert_allclose(cost, want_c, **TOL)
        np.testing.assert_array_equal(end, want_e)
    _, _, pstrips = wavefront.checkpoint_plain(qt, lay, n=n, w=w, spec=spec)
    np.testing.assert_allclose(strips, pstrips.numpy(), **TOL)
    # the reverse sweep over the flipped operands reads out the same cost
    qf = np.ascontiguousarray(q[:, ::-1])
    rlay = ops.prepare_reference_reverse(rt, w)
    rcost, rend, rstrips, _ = _kernel_sweep(qf, rlay.numpy(), n=n, w=w,
                                            spec=spec, reverse=True)
    want = wavefront.checkpoint_plain(torch.from_numpy(qf), rlay, n=n, w=w,
                                      spec=spec, reverse=True)
    np.testing.assert_allclose(rcost, want[0].numpy(), **TOL)
    np.testing.assert_allclose(rstrips, want[2].numpy(), **TOL)
    np.testing.assert_allclose(rcost, cost, **TOL)
    if case == "blocked_band":
        assert np.isinf(cost).all() and (end == 0).all()
    else:
        np.testing.assert_array_equal(rend, want[1].numpy())
    if case == "tie_across_warps":
        # the premise: two bottom-row minima, exactly equal, on two warps
        assert bottom[1, 29] == bottom[1, 99] == bottom[1].min() == 0
        assert end[1] == 29


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


def _k5_k6_pairs(q, r, n, w, spec):
    """(kernel, plain) for K5, K6-forward and K6-reverse on one input."""
    lay = ops.prepare_reference(r, w)
    rlay = ops.prepare_reference_reverse(r, w)
    qf = torch.flip(q, (1,)).contiguous()
    return [
        (wavefront.soft_wavefront(q, lay, n=n, w=w, spec=spec),
         wavefront.soft_plain(q, lay, n=n, w=w, spec=spec)),
        (wavefront.soft_checkpoint(q, lay, n=n, w=w, spec=spec),
         wavefront.checkpoint_plain(q, lay, n=n, w=w, spec=spec)),
        (wavefront.soft_checkpoint(qf, rlay, n=n, w=w, spec=spec,
                                   reverse=True),
         wavefront.checkpoint_plain(qf, rlay, n=n, w=w, spec=spec,
                                    reverse=True))]


def _assert_k5_k6(pairs, what):
    what = str(what)
    torch.cuda.synchronize()
    for k, (got, want) in enumerate(pairs):
        torch.testing.assert_close(got[0], want[0], **TOL, msg=what)
        if k < 2:
            assert torch.equal(got[1], want[1]), what
        if k:
            torch.testing.assert_close(got[2], want[2], **TOL, msg=what)
    fwd, rev = pairs[1][0][0], pairs[2][0][0]
    torch.testing.assert_close(rev, fwd, rtol=1e-5, atol=1e-5, msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("gamma,band,distance", [
    (0.01, None, "sqeuclidean"), (0.1, 64, "abs"), (1.0, 900, "sqeuclidean"),
    (0.5, None, "abs")])
def test_k5_and_k6_at_every_chunk_count_on_card(cuda, gamma, band,
                                                distance):
    """Visited chunks fewer than, equal to and one more than the warps of
    a CTA, and 2P+1 (idle warps, a ring that wraps; under a band the
    reverse sweep starts chunk0 chunks in), at every width."""
    spec = _soft(gamma, band, distance)
    P = wavefront.WARPS
    for w in wavefront.WIDTHS:
        W = wavefront.chunk_cols(w)
        for n in ((k - 1) * W + W // 2 + 3
                  for k in (1, P - 1, P, P + 1, 2 * P + 1)):
            q, r = (torch.from_numpy(x).to(cuda)
                    for x in _inputs(3, 33, n, seed=n))
            _assert_k5_k6(_k5_k6_pairs(q, r, n, w, spec), (w, n))


@pytest.mark.gpu
def test_k5_and_k6_at_their_longest_query_on_card(cuda):
    """The longest query the soft kernel takes (its dynamic and static
    shared memory together at the block's limit), all three plans."""
    spec = _soft(1.0)
    m, n = wavefront.longest_query(spec), 100
    assert m == 26_912
    q, r = (torch.from_numpy(x).to(cuda) for x in _inputs(1, m, n, seed=6))
    _assert_k5_k6(_k5_k6_pairs(q, r, n, 2, spec), m)
