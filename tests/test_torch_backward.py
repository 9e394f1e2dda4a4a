"""Gradients of soft-min sDTW in the port against the JAX package:
``repro_torch.sdtw`` (kernel backend: the fused K6 pair and tile pass,
here through their plain versions; engine: autograd through the sweep)
and ``repro_torch.train.make_sdtw_loss`` against ``jax.grad`` through
``repro.core.softdtw.sdtw_soft`` and ``repro.train.make_sdtw_loss``; the
normalizer's analytic backward; the reverse readout; padding; the
memory contract of the fused path; on the card, the fused gradient
against engine autograd."""
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch
from repro_torch.core.engine import sdtw_engine
from repro_torch.core.spec import DPSpec
from repro_torch.kernels import backward, normalizer, ops, wavefront
from repro_torch.train.step import make_sdtw_loss

TOL = dict(rtol=1e-4, atol=1e-4)
B, M, N = 3, 20, 600          # w=2 -> 64-column chunks: N spans 10
MATRIX = [(g, band) for g in (0.01, 0.1, 1.0) for band in (None, 40)]


def _soft(gamma, band=None, distance="sqeuclidean"):
    return DPSpec(reduction="softmin", gamma=gamma, band=band,
                  distance=distance)


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core.normalize import normalize_batch
    from repro.core.softdtw import sdtw_soft
    from repro.train.step import make_sdtw_loss as jax_loss

    def grad_soft(q, r, gamma, band, weights):
        def f(qq, rr):
            return jnp.sum(sdtw_soft(qq, rr, gamma=gamma, band=band)
                           * jnp.asarray(weights))
        return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(
            jnp.asarray(q), jnp.asarray(r))]

    def grad_loss(q, r, gamma):
        def f(qq, rr):
            return jax_loss(rr, gamma=gamma, backend="engine")(qq)
        val, grads = jax.value_and_grad(f, argnums=(0, 1))(
            jnp.asarray(q), jnp.asarray(r))
        return float(val), [np.asarray(g) for g in grads]

    def grad_norm(x, g):
        return np.asarray(jax.grad(lambda xx: jnp.sum(
            normalize_batch(xx) * jnp.asarray(g)))(jnp.asarray(x)))

    return types.SimpleNamespace(grad_soft=grad_soft, grad_loss=grad_loss,
                                 grad_norm=grad_norm, jax=jax, jnp=jnp)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest -m gpu` on the H100")
    return torch.device("cuda")


def _inputs(b, m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, m)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32))


def _port_grads(q, r, spec, backend, weights, w=2, device="cpu"):
    qt = torch.from_numpy(q).to(device).requires_grad_()
    rt = torch.from_numpy(r).to(device).requires_grad_()
    res = repro_torch.sdtw(qt, rt, spec=spec, backend=backend,
                           normalize=False, segment_width=w, device=device)
    (res.cost * torch.as_tensor(weights, device=device)).sum().backward()
    return res.cost.detach(), qt.grad, rt.grad


@pytest.mark.parametrize("gamma,band", MATRIX,
                         ids=[f"g{g}-band{b}" for g, b in MATRIX])
@pytest.mark.parametrize("backend", ["kernel", "engine"])
def test_sdtw_grads_match_jax(jx, gamma, band, backend):
    q, r = _inputs(B, M, N, seed=7)
    weights = np.ones(B, np.float32)
    gq, gr = jx.grad_soft(q, r, gamma, band, weights)
    for w in ((2, 8) if backend == "kernel" else (2,)):
        _, pq, pr = _port_grads(q, r, _soft(gamma, band), backend, weights,
                                w=w)
        np.testing.assert_allclose(pq.numpy(), gq, **TOL)
        np.testing.assert_allclose(pr.numpy(), gr, **TOL)


@pytest.mark.parametrize("distance", ["sqeuclidean", "abs"])
def test_fused_grads_match_engine_autograd(distance):
    q, r = _inputs(2, 12, 333, seed=3)
    spec = _soft(0.3, distance=distance)
    weights = [1.0, -0.5]                   # the cost cotangent is used
    _, eq, er = _port_grads(q, r, spec, "engine", weights)
    for w in (2, 4):
        _, kq, kr = _port_grads(q, r, spec, "kernel", weights, w=w)
        torch.testing.assert_close(kq, eq, **TOL)
        torch.testing.assert_close(kr, er, **TOL)


@pytest.mark.parametrize("backend", ["kernel", "engine"])
def test_make_sdtw_loss_matches_jax(jx, backend):
    """normalize=True: the gradient crosses the normalizer's backward,
    to the predictions and to the reference."""
    rng = np.random.default_rng(11)
    q = (rng.normal(size=(4, 24)) * 2 + 1).astype(np.float32)
    r = np.cumsum(rng.normal(size=500)).astype(np.float32)
    val, (gq, gr) = jx.grad_loss(q, r, 0.5)
    pred = torch.from_numpy(q).requires_grad_()
    ref = torch.from_numpy(r).requires_grad_()
    loss = make_sdtw_loss(ref, gamma=0.5, backend=backend, device="cpu",
                          segment_width=2)(pred)
    loss.backward()
    np.testing.assert_allclose(loss.item(), val, **TOL)
    np.testing.assert_allclose(pred.grad.numpy(), gq, **TOL)
    np.testing.assert_allclose(ref.grad.numpy(), gr, **TOL)


def test_make_sdtw_loss_reductions():
    q, r = _inputs(3, 10, 150, seed=12)
    pred = torch.from_numpy(q)
    per = make_sdtw_loss(r, gamma=0.5, reduce="none", device="cpu")(pred)
    assert per.shape == (3,)
    for reduce, want in (("mean", per.mean()), ("sum", per.sum())):
        got = make_sdtw_loss(r, gamma=0.5, reduce=reduce, device="cpu")(pred)
        torch.testing.assert_close(got, want)
    with pytest.raises(ValueError, match="reduce must be"):
        make_sdtw_loss(r, reduce="max", device="cpu")


def test_sgd_steps_lower_the_loss():
    rng = np.random.default_rng(13)
    pred = torch.from_numpy(rng.normal(size=(8, 32)).astype(np.float32))
    pred.requires_grad_()
    ref = np.cumsum(rng.normal(size=600)).astype(np.float32)
    loss_fn = make_sdtw_loss(ref, gamma=0.5, device="cpu",
                             backend="kernel")
    losses = []
    for _ in range(5):
        loss = loss_fn(pred)
        loss.backward()
        with torch.no_grad():
            pred -= 0.8 * pred.grad
        pred.grad = None
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("shape", [(4, 50), (3, 7)])
def test_normalizer_backward_matches_jax(jx, shape):
    rng = np.random.default_rng(shape[1])
    x = (rng.normal(size=shape) * 3 + 2).astype(np.float32)
    x[1] = 4.0                          # a constant row: the eps clamp
    g = rng.normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = normalizer.normalize(xt)
    (y * torch.from_numpy(g)).sum().backward()
    want = jx.grad_norm(x, g)
    np.testing.assert_allclose(y.detach().numpy(),
                               normalizer.normalize_plain(
                                   torch.from_numpy(x)).numpy())
    live = [i for i in range(shape[0]) if i != 1]
    np.testing.assert_allclose(xt.grad.numpy()[live], want[live], **TOL)
    # where the clamp holds, std is a constant: no gradient through var
    std = np.sqrt(1e-12)
    np.testing.assert_allclose(xt.grad.numpy()[1],
                               (g[1] - g[1].mean()) / std, rtol=1e-3)


@pytest.mark.parametrize("gamma,band", [(1.0, None), (0.1, 40), (0.5, 3)])
def test_reverse_readout_equals_forward_cost(gamma, band):
    q, r = _inputs(3, 16, 400, seed=17)
    qn = normalizer.normalize(torch.from_numpy(q))
    rn = normalizer.normalize(torch.from_numpy(r))
    for w in (2, 4):
        cost, end, rcost, fck, rck = backward.checkpoint_sweeps(
            qn, rn, spec=_soft(gamma, band), segment_width=w)
        torch.testing.assert_close(rcost, cost, rtol=1e-5, atol=1e-5)
        chunks = wavefront.band_grid_chunks(16, band,
                                            wavefront.num_chunks(400, w), w)
        assert fck.shape == rck.shape == (3, chunks, 16)
        assert (fck[:, 0] == 1e30).all() and (rck[:, 0] == 1e30).all()


def test_pad_columns_do_not_leak_into_the_reference_gradient(jx):
    """n = 150 is not a multiple of the 64-column chunk: the flipped left
    neighbour of column n-1 is a pad column, which the reverse sweep must
    mask, and E must be 0 there."""
    q, r = _inputs(2, 6, 150, seed=19)
    weights = [1.0, 1.0]
    gq, gr = jx.grad_soft(q, r, 0.5, None, weights)
    _, pq, pr = _port_grads(q, r, _soft(0.5), "kernel", weights, w=2)
    np.testing.assert_allclose(pr.numpy(), gr, **TOL)
    assert abs(float(pr[-1]) - float(gr[-1])) < 1e-5
    assert abs(float(pr[-1])) > 1e-3          # the last column matters
    spec = _soft(0.5)
    _, _, E = backward.soft_alignment_fused(torch.from_numpy(q),
                                            torch.from_numpy(r), spec=spec,
                                            segment_width=2)
    assert E.shape == (2, 6, 150)
    rt = torch.from_numpy(r)
    layout = ops.prepare_reference_reverse(rt, 2)
    assert float(layout[:192 - 150].abs().sum()) == 0.0   # left padding
    assert torch.equal(layout[192 - 150:], torch.flip(rt, (0,)))


@pytest.mark.parametrize("backend", ["kernel", "engine"])
def test_blocked_band_zero_gradients(backend):
    q, r = _inputs(2, 30, 12, seed=21)
    cost, pq, pr = _port_grads(q, r, _soft(0.5, 2), backend, [1.0, 1.0])
    assert torch.isinf(cost).all()
    assert float(pq.abs().sum()) == 0.0 and float(pr.abs().sum()) == 0.0


def test_forward_only_call_runs_no_checkpoint(monkeypatch):
    """Without autograd the kernel backend pays plain K5 and no K6."""
    def forbid(*_, **__):
        raise AssertionError("a checkpoint sweep ran")
    q, r = _inputs(2, 8, 100, seed=22)
    with torch.no_grad():
        monkeypatch.setattr(wavefront, "soft_checkpoint", forbid)
        got = repro_torch.sdtw(torch.from_numpy(q).requires_grad_(), r,
                               gamma=0.5, backend="kernel", device="cpu")
    assert not got.cost.requires_grad


def test_aligner_gradient_reuses_its_layouts(monkeypatch):
    """Training through an Aligner builds the forward and reverse
    layouts once; neither the K6 pair nor the backward rebuilds them."""
    q, r = _inputs(2, 10, 300, seed=24)
    al = repro_torch.Aligner(r, gamma=0.5, backend="kernel", device="cpu",
                             segment_width=2)
    eng = repro_torch.Aligner(r, gamma=0.5, backend="engine", device="cpu")
    al.layout(), al.layout(reverse=True)
    built = []
    for name in ("prepare_reference", "prepare_reference_reverse"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=real, **k:
                            built.append(_f) or _f(*a, **k))
    for step in range(2):
        qk = torch.from_numpy(q + step).requires_grad_()
        qe = torch.from_numpy(q + step).requires_grad_()
        al(qk).cost.sum().backward()
        eng(qe).cost.sum().backward()
        torch.testing.assert_close(qk.grad, qe.grad, **TOL)
    assert built == [] and al.stats.layout_builds == 2


class _Sizes(TorchDispatchMode):
    """Records the largest tensor any op produces."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_fused_gradient_path_holds_no_bmn_tensor():
    b, m, n, w = 2, 8, 2000, 2          # B*M*N = 32,000 > every tile
    q, r = _inputs(b, m, n, seed=23)
    qt = torch.from_numpy(q).requires_grad_()
    rt = torch.from_numpy(r).requires_grad_()
    spec = _soft(0.5)
    sizes = _Sizes()
    with sizes:
        cost, _ = backward.sdtw_soft_fused(qt, rt, spec=spec,
                                           segment_width=w)
        cost.sum().backward()
    assert 0 < sizes.largest < b * m * n, sizes.largest
    # the engine's autograd oracle agrees
    qe = torch.from_numpy(q).requires_grad_()
    re_ = torch.from_numpy(r).requires_grad_()
    sdtw_engine(qe, re_, spec=spec)[0].sum().backward()
    torch.testing.assert_close(qt.grad, qe.grad, **TOL)
    torch.testing.assert_close(rt.grad, re_.grad, **TOL)


def test_pallas_fused_backward_where_it_traces(jx):
    """The JAX package's fused custom_vjp in interpret mode, where this
    JAX can trace the Pallas kernel (it needs ``pallas.load``)."""
    from jax.experimental import pallas as pl
    if not hasattr(pl, "load"):
        pytest.skip("this JAX's pallas has no `load`: the Pallas wavefront "
                    "does not trace here")
    from repro.core.spec import DPSpec as JaxSpec
    from repro.kernels import backward as jb
    q, r = _inputs(B, M, N, seed=7)
    jspec = JaxSpec(reduction="softmin", gamma=0.1)

    def f(qq, rr):
        return jb.sdtw_soft_fused(qq, rr, spec=jspec, segment_width=2,
                                  interpret=True)[0].sum()
    gq, gr = jx.jax.grad(f, argnums=(0, 1))(jx.jnp.asarray(q),
                                            jx.jnp.asarray(r))
    _, pq, pr = _port_grads(q, r, _soft(0.1), "kernel", [1.0] * B)
    np.testing.assert_allclose(pq.numpy(), np.asarray(gq), **TOL)
    np.testing.assert_allclose(pr.numpy(), np.asarray(gr), **TOL)


# ------------------------------------------------------------- the card
@pytest.mark.gpu
@pytest.mark.parametrize("gamma,band", MATRIX,
                         ids=[f"g{g}-band{b}" for g, b in MATRIX])
def test_fused_grads_match_engine_on_card(cuda, gamma, band):
    q, r = _inputs(B, M, N, seed=7)
    spec = _soft(gamma, band)
    weights = [1.0, -0.5, 2.0]
    before = dict(wavefront.soft_counter.by_variant)
    _, kq, kr = _port_grads(q, r, spec, "kernel", weights, w=2,
                            device=cuda)
    after = wavefront.soft_counter.by_variant
    assert after.get("K6-forward", 0) == before.get("K6-forward", 0) + 1
    assert after.get("K6-reverse", 0) == before.get("K6-reverse", 0) + 1
    _, eq, er = _port_grads(q, r, spec, "engine", weights, device=cuda)
    torch.testing.assert_close(kq, eq, **TOL)
    torch.testing.assert_close(kr, er, **TOL)
