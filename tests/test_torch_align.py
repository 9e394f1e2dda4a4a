"""repro_torch.align against repro.align: the Hirschberg warping paths
equal the JAX package's cell for cell and both packages' full-matrix
oracle, the oracle windows agree, the path invariants hold on a planted
CBF window, and ``outputs=("path",)`` through ``sdtw`` and ``Aligner``
equals ``repro.sdtw``'s.  Inputs are used as given (``normalize=False``),
as ``tests/test_align.py`` does; on the card, a path from K3's window
equals the path from the plain version's."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.align.traceback as port_traceback
from repro_torch.align import (oracle_path, oracle_window, warping_path,
                               warping_paths, window_arrays)
from repro_torch.core.spec import DPSpec, NO_WINDOW
from repro_torch.kernels import wavefront

B, M, N = 3, 16, 120

PATH_SPECS = [DPSpec(), DPSpec(distance="abs"), DPSpec(band=30)]
WINDOW_SPECS = [                       # repro's tests/test_align.py matrix
    DPSpec(),
    DPSpec(distance="abs"),
    DPSpec(band=24),
    DPSpec(distance="abs", band=40),
    DPSpec(band=N + M),                # band wider than the matrix
]
PATHS = ("cost", "start", "end", "path")


@pytest.fixture
def jx():
    """The JAX package's align, front door and CBF generator, imported
    here so the card-only tests of this file also run where JAX is not
    installed."""
    pytest.importorskip("jax")
    import types

    import repro
    import repro.align.traceback as jax_traceback
    from repro.align import oracle_path as jax_oracle_path
    from repro.align import oracle_window as jax_oracle_window
    from repro.align import warping_path as jax_warping_path
    from repro.align import warping_paths as jax_warping_paths
    from repro.core.spec import DPSpec as JaxSpec
    from repro.data.cbf import make_cylinder_bell_funnel

    def spec(s):
        return JaxSpec(**dataclasses.asdict(s))

    return types.SimpleNamespace(
        sdtw=repro.sdtw, Aligner=repro.Aligner, traceback=jax_traceback,
        oracle_path=jax_oracle_path, oracle_window=jax_oracle_window,
        warping_path=jax_warping_path, warping_paths=jax_warping_paths,
        spec=spec,
        cbf=make_cylinder_bell_funnel)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    q = rng.normal(size=(B, M)).astype(np.float32)
    r = rng.normal(size=(N,)).astype(np.float32)
    return q, r


def _znorm(x):
    x = np.asarray(x, np.float64)
    mu = x.mean(-1, keepdims=True)
    return ((x - mu) / np.sqrt(np.maximum(
        (x * x).mean(-1, keepdims=True) - mu * mu, 1e-12))).astype(
            np.float32)


@pytest.fixture
def cbf(jx):
    """z-normalized CBF queries and reference with one planted exact
    match (query 1 at columns 100..131)."""
    rng = np.random.default_rng(4)
    q = _znorm(jx.cbf(rng, 4, 32))
    r = _znorm(jx.cbf(rng, 1, 512)[0])
    r[100:132] = q[1]
    return q, r


@pytest.mark.parametrize("spec", PATH_SPECS, ids=lambda s: s.describe())
def test_paths_equal_jax_and_both_oracles(jx, data, spec, monkeypatch):
    """Hirschberg == JAX's Hirschberg == both full-matrix backtracks,
    cell for cell, with the base case shrunk so the recursion
    recurses."""
    q, r = data
    monkeypatch.setattr(port_traceback, "_BASE_CELLS", 16)
    monkeypatch.setattr(jx.traceback, "_BASE_CELLS", 16)
    got = warping_paths(q, r, spec=spec, normalize=False, device="cpu")
    want = jx.warping_paths(q, r, spec=jx.spec(spec), normalize=False)
    for b in range(B):
        oracle = oracle_path(q[b], r, spec)
        assert np.array_equal(oracle, jx.oracle_path(q[b], r,
                                                     jx.spec(spec)))
        assert got[b].dtype == np.int64
        assert np.array_equal(got[b], want[b]), (spec.describe(), b)
        assert np.array_equal(got[b], oracle), (spec.describe(), b)


@pytest.mark.parametrize("spec", WINDOW_SPECS, ids=lambda s: s.describe())
def test_oracle_window_equals_jax(jx, data, spec):
    q, r = data
    for b in range(B):
        cost, start, end = oracle_window(q[b], r, spec)
        want = jx.oracle_window(q[b], r, jx.spec(spec))
        assert (start, end) == want[1:]
        assert cost == want[0]


@pytest.mark.parametrize("spec", WINDOW_SPECS, ids=lambda s: s.describe())
def test_kernel_windows_equal_the_oracle(data, spec):
    """The window every path is pinned to: K3's plain version (K4's with
    a band) against the float64 oracle."""
    q, r = data
    res = repro_torch.sdtw(q, r, outputs=("cost", "start", "end"),
                           normalize=False, backend="kernel", spec=spec,
                           segment_width=2, device="cpu")
    for b in range(B):
        cost, start, end = oracle_window(q[b], r, spec)
        assert (int(res.start[b]), int(res.end[b])) == (start, end)
        np.testing.assert_allclose(float(res.cost[b]), cost, rtol=2e-3,
                                   atol=2e-3)


def test_path_invariants_on_a_planted_window(cbf):
    """First cell (0, start), last (M-1, end), unit monotone steps, inside
    the band, and the summed cell costs equal the sweep's cost."""
    q, r = cbf
    spec = DPSpec(band=400)
    res = repro_torch.sdtw(q, r, outputs=PATHS, normalize=False,
                           spec=spec, backend="kernel", device="cpu")
    assert (int(res.start[1]), int(res.end[1])) == (100, 131)
    for b in range(len(q)):
        path = res.path[b]
        assert tuple(path[0]) == (0, int(res.start[b]))
        assert tuple(path[-1]) == (len(q[b]) - 1, int(res.end[b]))
        steps = set(map(tuple, np.diff(path, axis=0)))
        assert steps <= {(0, 1), (1, 0), (1, 1)}
        assert (np.abs(path[:, 0] - path[:, 1]) <= spec.band).all()
        cost = sum((float(q[b][i]) - float(r[j])) ** 2 for i, j in path)
        np.testing.assert_allclose(cost, float(res.cost[b]), rtol=1e-3,
                                   atol=1e-3)
    assert np.array_equal(res.path[1][:, 1] - res.path[1][:, 0],
                          np.full(32, 100))     # the exact match
    (sl,) = window_arrays(res.start[1:2], res.end[1:2])
    assert sl == slice(100, 132)


@pytest.mark.parametrize("backend", [None, "kernel", "engine", "ref"])
@pytest.mark.parametrize("band", [None, 30])
def test_front_door_and_aligner_paths_equal_jax(jx, data, backend, band):
    q, r = data
    spec = DPSpec(band=band)
    want = jx.sdtw(q, r, outputs=PATHS, normalize=False,
                   spec=jx.spec(spec))
    got = repro_torch.sdtw(q, r, outputs=PATHS, normalize=False,
                           spec=spec, backend=backend, device="cpu")
    session = repro_torch.Aligner(r, spec=spec, backend=backend,
                                  normalize=False, outputs=("path",),
                                  device="cpu")
    via_session = session(q, outputs=("cost", "path"))
    assert via_session.start is None and via_session.end is None
    np.testing.assert_array_equal(got.start.numpy(), np.asarray(want.start))
    np.testing.assert_array_equal(got.end.numpy(), np.asarray(want.end))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=2e-3, atol=2e-3)
    for b in range(B):
        assert np.array_equal(got.path[b], np.asarray(want.path[b]))
        assert np.array_equal(via_session.path[b], got.path[b])
    only = repro_torch.sdtw(q, r, outputs="path", normalize=False,
                            spec=spec, backend=backend, device="cpu")
    assert only.present == frozenset({"path"})
    assert all(np.array_equal(a, b) for a, b in zip(only.path, got.path))


def test_normalized_paths_follow_the_normalized_window(data):
    """With normalize=True the paths are the traceback of the normalized
    operands inside the window of the same sweep."""
    from repro_torch.core.normalize import normalize_batch
    q, r = data
    res = repro_torch.sdtw(q, r, outputs=PATHS, device="cpu",
                           backend="kernel")
    qn = normalize_batch(torch.from_numpy(q)).numpy()
    rn = normalize_batch(torch.from_numpy(r)).numpy()
    for b in range(B):
        want = warping_path(qn[b], rn, normalize=False,
                            window=(int(res.start[b]), int(res.end[b])))
        assert np.array_equal(res.path[b], want)
        assert np.array_equal(res.path[b], warping_path(
            q[b], r, device="cpu"))


def test_banded_path_masks_global_columns(jx):
    """Under a band the traceback masks GLOBAL columns: a window right of
    column 0 keeps its in-band path, equal to the full-matrix oracle's.
    The reference masks window-local columns, and raises IndexError on
    this input (ROADMAP, caveats in the reference)."""
    rng = np.random.default_rng(12)
    r = rng.normal(size=(3_000,)).astype(np.float32)
    starts = rng.integers(0, 3_000 - 200, size=8)
    q = (np.stack([r[s:s + 200] for s in starts]) + rng.uniform(
        -0.05, 0.05, size=(8, 200))).astype(np.float32)[2:4]
    spec = DPSpec(band=40)
    res = repro_torch.sdtw(q, r, outputs=PATHS, spec=spec,
                           normalize=False, backend="kernel", device="cpu")
    for b in range(len(q)):
        s, e = int(res.start[b]), int(res.end[b])
        assert s > 0
        want = oracle_path(q[b], r[:e + 1], spec, end=e)
        assert np.array_equal(res.path[b], want)
        assert (np.abs(want[:, 0] - want[:, 1]) <= spec.band).all()
        with pytest.raises(IndexError):
            jx.warping_path(q[b], r, spec=jx.spec(spec), normalize=False,
                            window=(s, e))


def test_blocked_band_gives_no_path(rng):
    """M > N + band: no in-band alignment, a NO_WINDOW start and a None
    path, through sdtw and Aligner alike."""
    q = rng.normal(size=(2, 6)).astype(np.float32)
    r = rng.normal(size=(3,)).astype(np.float32)
    for backend in ("kernel", "engine"):
        res = repro_torch.sdtw(q, r, outputs=PATHS, band=1,
                               backend=backend, device="cpu")
        assert (res.start == NO_WINDOW).all()
        assert res.path == [None, None]
        a = repro_torch.Aligner(r, band=1, backend=backend, device="cpu")
        assert a(q, outputs="path").path == [None, None]


def test_path_errors(data):
    q, r = data
    with pytest.raises(ValueError, match="bad window"):
        warping_path(q[0], r, normalize=False, window=(40, 20))
    with pytest.raises(ValueError, match="bad window"):
        warping_path(q[0], r, normalize=False, window=(0, N))
    with pytest.raises(ValueError, match="hard-min spec"):
        warping_path(q[0], r, spec=DPSpec(reduction="softmin"),
                     device="cpu")
    with pytest.raises(ValueError, match="under soft-min"):
        repro_torch.sdtw(q, r, gamma=0.5, outputs=("cost", "path"),
                         device="cpu")
    with pytest.raises(ValueError,
                       match="output 'path' for family 'twed'"):
        repro_torch.sdtw(q, r, family="twed", outputs="path",
                         device="cpu")
    with pytest.raises(ValueError, match="output 'path' for family"):
        repro_torch.Aligner(r, spec=DPSpec(family="local"),
                            device="cpu")(q, outputs="path")
    with pytest.raises(ValueError, match="hard-min only"):
        oracle_path(q[0], r, DPSpec(reduction="softmin"))


def test_auto_width_serves_paths(data):
    """A path request tunes the window sweep and gives the pinned
    width's paths."""
    from repro_torch import tune
    q, r = data
    cpu = torch.device("cpu")
    prev = tune.set_default_cache(tune.TuningCache(None, device=cpu),
                                  device=cpu)
    try:
        got = repro_torch.sdtw(q, r, outputs=PATHS, backend="kernel",
                               segment_width="auto", normalize=False,
                               device=cpu)
    finally:
        tune.set_default_cache(prev, device=cpu)
    pin = repro_torch.sdtw(q, r, outputs=PATHS, backend="kernel",
                           normalize=False, device=cpu)
    assert torch.equal(got.start, pin.start)
    assert all(np.array_equal(a, b) for a, b in zip(got.path, pin.path))


# ------------------------------------------------------------- on card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest -m gpu` on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("band", [None, 40])
def test_card_window_paths_equal_plain_window_paths(cuda, band):
    """The path from K3's window (K4's under a band) on the card equals
    the path from the plain version's window on the same operands
    (used as given: K2 agrees with its plain version to 1e-5, not bit
    for bit)."""
    rng = np.random.default_rng(12)
    r = rng.normal(size=(3_000,)).astype(np.float32)
    starts = rng.integers(0, 3_000 - 200, size=8)
    q = np.stack([r[s:s + 200] for s in starts]) + rng.uniform(
        -0.05, 0.05, size=(8, 200)).astype(np.float32)
    spec = DPSpec(band=band)
    wavefront.counter.reset()
    got = repro_torch.sdtw(q, r, outputs=PATHS, spec=spec,
                           normalize=False, device=cuda)
    torch.cuda.synchronize()
    assert wavefront.counter.by_variant.get("K4" if band else "K3") == 1
    plain = repro_torch.sdtw(q, r, outputs=PATHS, spec=spec,
                             normalize=False, backend="kernel",
                             device="cpu")
    assert torch.equal(got.start.cpu(), plain.start)
    assert torch.equal(got.end.cpu(), plain.end)
    for b in range(len(q)):
        assert np.array_equal(got.path[b], plain.path[b])
