"""bf16-K1: the hard-min wavefront with a bf16 compute type.  Its plain
version (the engine in bf16, float32 fold) against the float32 answer
at the JAX package's own bar, against the JAX engine's bf16 sweep bit
for bit, against the Pallas kernel where this JAX traces it, its shaped
errors; on the card, the kernel against its plain
version bit for bit."""
import numpy as np
import pytest
import torch

from repro_torch.core.engine import sdtw_engine
from repro_torch.core.ref import sdtw_ref
from repro_torch.core.spec import DPSpec
from repro_torch.kernels import ops, wavefront

BF16 = torch.bfloat16
JAX_BAR = dict(rtol=0.1, atol=0.3)     # tests/test_kernel_sdtw.py:46-55


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest -m gpu` on the H100")
    return torch.device("cuda")


def _inputs(b, m, n, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(b, m)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)))


@pytest.mark.parametrize("band,distance,window", [
    (None, "sqeuclidean", False), (None, "abs", True),
    (20, "sqeuclidean", True), (5, "abs", False)])
def test_bf16_within_the_jax_bar_of_float32(band, distance, window):
    """The JAX test's shape (2 x 16 against 256, w 4), every plan."""
    q, r = _inputs(2, 16, 256, seed=0)
    spec = DPSpec(band=band, distance=distance)
    got = ops.sdtw_wavefront(q, r, segment_width=4, spec=spec,
                             return_window=window, compute_dtype=BF16)
    want = sdtw_ref(q, r, spec, return_window=window)
    torch.testing.assert_close(got[0], want[0], **JAX_BAR)
    assert got[0].dtype == torch.float32
    # every cost is a bf16 value
    assert torch.equal(got[0], got[0].to(BF16).float())


def test_bf16_plain_is_the_engine_in_bf16():
    """The plain version rounds every cell operation to bf16 (torch's
    bf16 ops compute in float32 and round), folds in float32, and reads
    the same layout at every width."""
    q, r = _inputs(3, 20, 150, seed=1)
    spec = DPSpec()
    want = sdtw_engine(q.to(BF16), r.to(BF16), spec=spec,
                       compute_dtype=BF16)
    for w in (2, 8):
        got = wavefront.wavefront(q, wavefront.prepare_reference(r, w), n=150,
                                  w=w, spec=spec, compute_dtype=BF16)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # and it differs from float32: the compute type is really bf16
    f32 = sdtw_engine(q, r, spec=spec)
    assert not torch.equal(f32[0], want[0])


@pytest.mark.parametrize("b,m,n,band,distance", [
    (3, 26, 30, None, "sqeuclidean"), (3, 26, 300, 8, "abs"),
    (2, 16, 256, None, "sqeuclidean"), (2, 520, 800, 40, "sqeuclidean"),
    (2, 600, 900, None, "abs")])
def test_bf16_equals_the_jax_engine_in_bf16(b, m, n, band, distance):
    """The JAX package runs the same bf16 sweep without Pallas:
    ``repro.core.engine.sdtw_engine(accum_dtype=bfloat16)``.  The port's
    engine and its bf16 wavefront (K1's plain version here) give its
    costs and ends exactly.  At M >= 500 the bf16 costs stall below the
    float32 ones (an accumulator of a few hundred has a bf16 ulp of 1 or
    2, so small cell costs round away), outside the JAX bar, in the JAX
    engine and the port alike."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.engine import sdtw_engine as jax_engine
    from repro.core.spec import DPSpec as JaxSpec
    q, r = _inputs(b, m, n, seed=4)
    jc, je = jax_engine(jnp.asarray(q.numpy()), jnp.asarray(r.numpy()),
                        spec=JaxSpec(band=band, distance=distance),
                        accum_dtype=jnp.bfloat16)
    jc = torch.from_numpy(np.array(jc.astype(jnp.float32)))
    je = torch.from_numpy(np.array(je)).to(torch.int32)
    spec = DPSpec(band=band, distance=distance)
    for got in (sdtw_engine(q, r, spec=spec, compute_dtype=BF16),
                ops.sdtw_wavefront(q, r, segment_width=2, spec=spec,
                                   compute_dtype=BF16)):
        assert torch.equal(got[0], jc), (got[0], jc)
        assert torch.equal(got[1], je), (got[1], je)
    if m >= 500:
        f32 = sdtw_ref(q, r, spec)[0]
        assert bool((jc < f32).all())
        assert not bool(torch.isclose(jc, f32, **JAX_BAR).any())


def test_bf16_matches_the_pallas_kernel_where_it_traces():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    q, r = _inputs(2, 16, 256, seed=0)
    try:
        c, e = jops.sdtw_wavefront(jnp.asarray(q.numpy()),
                                   jnp.asarray(r.numpy()), segment_width=4,
                                   compute_dtype=jnp.bfloat16,
                                   interpret=True)
    except AttributeError as err:      # no pl.load in this JAX
        pytest.skip(f"the Pallas wavefront does not trace on this JAX "
                    f"({err}); ROADMAP 'How a slice is held'")
    got = ops.sdtw_wavefront(q, r, segment_width=4, compute_dtype=BF16)
    torch.testing.assert_close(got[0], torch.from_numpy(np.asarray(c)),
                               **JAX_BAR)


def test_bf16_errors():
    q, r = _inputs(2, 8, 64, seed=2)
    with pytest.raises(ValueError, match="logsumexp pairs in float32"):
        ops.sdtw_wavefront(q, r, spec=DPSpec(reduction="softmin"),
                           compute_dtype=BF16)
    with pytest.raises(ValueError, match="runs the kernel in float32"):
        ops.sdtw_wavefront(q, r, spec=DPSpec(family="twed"),
                           compute_dtype=BF16)
    with pytest.raises(ValueError, match="compute_dtype must be"):
        ops.sdtw_wavefront(q, r, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="logsumexp pairs in float32"):
        wavefront.wavefront(q, wavefront.prepare_reference(r, 8), n=64,
                            w=8, spec=DPSpec(reduction="softmin"),
                            compute_dtype=BF16)
    assert wavefront.variant(DPSpec(band=3), False, BF16) == "bf16-K4"


@pytest.mark.gpu
@pytest.mark.parametrize("band", [None, 0, 900])
@pytest.mark.parametrize("window", [False, True])
def test_bf16_kernel_bit_equal_to_plain_on_card(cuda, band, window):
    q, r = (x.to(cuda) for x in _inputs(9, 200, 3000, seed=3))
    for distance in ("sqeuclidean", "abs"):
        spec = DPSpec(band=band, distance=distance)
        want = wavefront.wavefront_plain(
            q, wavefront.prepare_reference(r, 2), n=3000, w=2, spec=spec,
            with_window=window, compute_dtype=BF16)
        for w in wavefront.WIDTHS:
            before = wavefront.counter.count
            got = wavefront.wavefront(
                q, wavefront.prepare_reference(r, w), n=3000, w=w, spec=spec,
                with_window=window, compute_dtype=BF16)
            torch.cuda.synchronize()
            assert wavefront.counter.count == before + 1
            for a, b in zip(got, want):
                assert torch.equal(a, b), (w, distance, a[:4], b[:4])
