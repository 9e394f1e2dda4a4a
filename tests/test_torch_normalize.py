"""K2 of the port: repro_torch's normalizer against the JAX package's
plain-jnp normalizer and its Pallas kernel (interpret mode) on the CPU,
and the CUDA kernel against its plain version on the card."""
import types

import numpy as np
import pytest
import torch

from repro_torch.core.normalize import normalize_batch
from repro_torch.kernels import normalizer

# (batch, length): a batch not a multiple of 8, lengths not multiples of
# 128, and one long row (the PAPER reference length)
SHAPES = [(5, 200), (9, 128), (3, 1000), (1, 100_000)]


@pytest.fixture
def jx():
    """The JAX side of a parity test, imported here so the card-only
    tests of this file also run where JAX is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.normalize import normalize_batch
    from repro.kernels import ops
    return types.SimpleNamespace(
        plain=lambda x: np.asarray(normalize_batch(jnp.asarray(x))),
        pallas=lambda x: np.asarray(ops.normalize(jnp.asarray(x),
                                                  interpret=True)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest -m gpu` on the H100")
    return torch.device("cuda")


def _data(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 3 + 1).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_normalizers(jx, shape):
    x = _data(shape)
    got = normalize_batch(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jx.plain(x), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, jx.pallas(x), atol=1e-6, rtol=1e-6)


def test_constant_row_hits_the_eps_clamp(jx):
    """A constant row has zero variance: std is sqrt(eps) and the row
    normalizes to exact zeros, as in both JAX normalizers."""
    x = _data((3, 200))
    x[1] = 3.0
    got = normalize_batch(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_allclose(got, jx.plain(x), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, jx.pallas(x), atol=1e-6, rtol=1e-6)


def test_leading_axes_and_1d_reference(jx):
    x = _data((2, 3, 50))
    got = normalize_batch(torch.from_numpy(x))
    assert got.shape == (2, 3, 50) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jx.plain(x), atol=1e-6,
                               rtol=1e-6)
    r = _data((300,))
    np.testing.assert_allclose(normalize_batch(torch.from_numpy(r)).numpy(),
                               jx.plain(r), atol=1e-6, rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES + [(512, 2000)])
def test_kernel_matches_plain_on_card(cuda, shape):
    """Summation order differs from the plain version: atol=rtol=1e-5."""
    x = torch.from_numpy(_data(shape)).to(cuda)
    before = normalizer.counter.count
    got = normalizer.normalize(x)
    torch.cuda.synchronize()
    assert normalizer.counter.count == before + 1
    torch.testing.assert_close(got, normalizer.normalize_plain(x),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 513])
@pytest.mark.parametrize("n", [1, 31, 2001, 100_000, 100_003, 300_003])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_at_ragged_lengths_on_card(cuda, rows, n, offset):
    """Rows whose starts are not 16-byte aligned (n not a multiple of 4,
    or a view one float into its buffer), the row and cluster kernels
    (300,003 samples: the cluster kernel that reads its slice twice),
    with the (mean, var) the backward reads."""
    flat = torch.from_numpy(_data((rows * n + offset,), seed=n)).to(cuda)
    x = flat[offset:].view(rows, n)
    y, stats = normalizer.normalize_cuda(x, with_stats=True)
    want, want_stats = normalizer.normalize_plain(x, with_stats=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(stats, want_stats, atol=1e-5, rtol=1e-5)
