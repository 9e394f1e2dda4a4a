"""The design of the port's multi-warp wavefronts and K2 kernels, on the
CPU: the reassociated cell of ``csrc/wavefront.cu`` against the port's
``DPSpec.cell_update`` / ``start3``, a step-by-step model of the kernels'
mbarrier ring between the warps of a CTA (every row arrives at the right
chunk, K6 checkpoints what it reads, no geometry deadlocks), the host
helpers that size the hard-min, K5/K6 and soft K7 launches (and the
longest query each plan can launch) and K2's grid and cluster, and the
soft K7 of
``csrc/family_wavefront.cu`` emulated in torch (its base-2 soft-min with
the min's own term fixed at 1, its cell, its steady blocks and its folds)
against the port's ``DPSpec``."""
import itertools
import math

import numpy as np
import pytest
import torch

from repro_torch.core.spec import (DPSpec, KERNEL_BIG, SOFT_BIG,
                                   previous_samples, resolve_spec)
from repro_torch.kernels import family, normalizer, wavefront

PAPER_M = 2000

# costs and predecessor values with every tie pattern among three of them,
# the sentinel among the values
VALUES = (0.0, 0.5, 1.0, 2.0, KERNEL_BIG)


def _kernel_cell(cost, left, up, upleft, s_left, s_up, s_upleft):
    """The cell as wavefront.cu computes it: ``pre`` off the chain, then
    one min and one add after the left neighbour; the start from ``pre``."""
    pre = torch.minimum(up, upleft)
    val = cost + torch.minimum(left, pre)
    spre = torch.where(upleft < up, s_upleft, s_up)
    return val, torch.where(pre < left, spre, s_left)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reassociated_cell_equals_cell_update_and_start3(dtype):
    grid = torch.tensor(list(itertools.product(VALUES, repeat=4)),
                        dtype=torch.float32).to(dtype)
    cost, left, up, upleft = grid.unbind(1)
    n = grid.shape[0]
    s_left = torch.full((n,), 10, dtype=torch.int32)
    s_up = torch.full((n,), 20, dtype=torch.int32)
    s_upleft = torch.full((n,), 30, dtype=torch.int32)
    spec = DPSpec()
    want_v = spec.cell_update(cost, left, up, upleft)
    want_s = spec.start3(left, up, upleft, s_left, s_up, s_upleft)
    got_v, got_s = _kernel_cell(cost, left, up, upleft, s_left, s_up,
                                s_upleft)
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_s, want_s)
    # every tie pattern of (left, up, upleft) is among the cases
    ties = {(bool(a == b), bool(b == c), bool(a == c))
            for a, b, c in zip(left, up, upleft)}
    assert len(ties) == 5


# ------------------------------------------------------- the ring model
def _simulate_cta(m: int, chunks: int, warps: int, slots: int, *,
                  chunk0: int = 0, strips: dict | None = None):
    """Run the CTA's schedule (``csrc/ring.cuh::RingWalk``, which the
    hard-min kernel, K5/K6 and soft K7 all walk) step by step, the warps
    in turn, with each mbarrier a count of completed phases and each wait
    a test of its phase parity, as ``mbarrier.try_wait.parity`` tests it.
    ``chunks`` visited chunks, the first ``chunk0`` chunks into the
    layout (a band-skipped reverse sweep).  Returns the boundary rows
    each visited chunk read, {chunk: [(layout chunk, row), ...]}; fills
    ``strips`` with what K6 writes to each visited chunk's checkpoint
    strip, group by group as it is taken from the ring (SOFT_BIG rows
    for the first); raises when no warp can take a step (a deadlock)."""
    G = wavefront.RING_GROUP
    groups = -(-m // G)
    full = [[0] * slots for _ in range(warps)]      # [link][slot]
    empty = [[0] * slots for _ in range(warps)]
    data = [[None] * (slots * G) for _ in range(warps)]
    read = {c: [] for c in range(chunks)}

    def checkpoint(c, link, slot, g):
        if strips is not None:
            strip = strips.setdefault(c, [SOFT_BIG] * m)
            for x in range(min(G, m - g * G)):
                strip[g * G + x] = data[link][slot * G + x]

    def full_done(link, x):        # consumer: parity (x // slots) & 1
        return full[link][x % slots] % 2 != (x // slots) % 2

    def empty_done(link, x):       # producer: parity ((x // slots) & 1) ^ 1
        return empty[link][x % slots] % 2 == (x // slots) % 2

    def warp_program(p):           # yields True for a step, False to wait
        for c in range(p, chunks, warps):
            has_in, has_out = c > 0, c + 1 < chunks
            link_in, link_out = p, (p + 1) % warps
            in0 = ((c - 1) // warps) * groups if has_in else 0
            out0 = (c // warps) * groups
            rd = wr = None
            if strips is not None and not has_in:
                strips[c] = [SOFT_BIG] * m
            if has_in:
                while not full_done(link_in, in0):
                    yield False
                rd = in0 % slots
                checkpoint(c, link_in, rd, 0)
                read[c].append(data[link_in][rd * G])
            for t in range(m + 31):
                if t % G == G - 1:                      # the ring step
                    g = (t + 1) // G
                    if has_in:
                        empty[link_in][(in0 + g - 1) % slots] += 1
                    if has_out and g >= 2:
                        full[link_out][(out0 + g - 2) % slots] += 1
                    if has_in and g < groups:
                        while not full_done(link_in, in0 + g):
                            yield False
                        rd = (in0 + g) % slots
                        checkpoint(c, link_in, rd, g)
                    if has_out and g - 1 < groups:
                        while not empty_done(link_out, out0 + g - 1):
                            yield False
                        wr = (out0 + g - 1) % slots
                if rd is not None and t + 1 < m:        # lane 0 reads t+1
                    read[c].append(data[link_in][rd * G + (t + 1) % G])
                i = t - 31                               # lane 31 writes i
                if has_out and 0 <= i < m:
                    data[link_out][wr * G + i % G] = (chunk0 + c, i)
                yield True
            if has_out:
                full[link_out][(out0 + groups - 1) % slots] += 1
            yield True

    progs = {p: warp_program(p) for p in range(warps)}
    while progs:
        moved = False
        for p in list(progs):
            try:
                moved |= next(progs[p])
            except StopIteration:
                del progs[p]
                moved = True
        if not moved:
            raise RuntimeError(f"ring deadlock at m={m}, chunks={chunks}, "
                               f"warps={warps}, slots={slots}")
    return read


def _chunk_counts(P):
    # fewer chunks than warps, and every residue modulo the warps
    return sorted({1, 2, P - 1, P, P + 1, 2 * P + 1, 3 * P - 1} - {0})


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [1, 33, 200])
def test_ring_model_delivers_every_row_without_deadlock(warps, m):
    geo = wavefront.hard_geometry(m, with_window=True, warps=warps)
    for chunks in _chunk_counts(warps):
        read = _simulate_cta(m, chunks, warps, geo.slots)
        for c in range(chunks):
            want = [(c - 1, i) for i in range(m)] if c > 0 else []
            assert read[c] == want, (m, chunks, warps, c)


def test_ring_model_at_paper_length():
    """At PAPER's m the ring has two groups a link of slack: two fewer
    still complete, three fewer deadlock."""
    geo = wavefront.hard_geometry(PAPER_M, with_window=False)
    P = geo.warps
    read = _simulate_cta(PAPER_M, 2 * P + 1, P, geo.slots)
    assert read[P] == [(P - 1, i) for i in range(PAPER_M)]
    _simulate_cta(PAPER_M, 3 * P + 1, P, geo.slots - 2)
    with pytest.raises(RuntimeError, match="deadlock"):
        _simulate_cta(PAPER_M, 3 * P + 1, P, geo.slots - 3)


# -------------------------------------------------------- host helpers
@pytest.mark.parametrize("m", [1, 33, PAPER_M])
@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("with_window", [False, True])
def test_hard_geometry_fits_and_never_waits(m, warps, with_window):
    geo = wavefront.hard_geometry(m, with_window, warps)
    assert geo.warps == warps and geo.ring_rows == 32 * geo.slots
    assert geo.smem_bytes <= wavefront.SMEM_LIMIT
    # the rings hold a whole boundary column (below that a CTA can
    # deadlock: the ring model finds it), plus two groups a link
    assert warps * (geo.ring_rows - 64) >= m + 31
    lanes = 2 if with_window else 1
    assert geo.smem_bytes == (16 * warps * geo.slots + 4 * (m + 64)
                              + 4 * lanes * warps * geo.ring_rows)


def test_hard_geometry_at_paper_and_its_limit():
    k1 = wavefront.hard_geometry(PAPER_M, False)
    k3 = wavefront.hard_geometry(PAPER_M, True)
    assert (k1.warps, k1.slots, k1.smem_bytes) == (8, 10, 19_776)
    assert k3.smem_bytes == 30_016
    # four CTAs a SM (512 queries on 132 SMs) fit the SM's 228 KB
    assert 4 * (k3.smem_bytes + 1024) <= 233_472
    with pytest.raises(ValueError, match="1 to 8 warps"):
        wavefront.hard_geometry(PAPER_M, False, 9)
    m = 20_000        # over the limit: a shaped error, not a bad launch
    assert wavefront.hard_geometry(m, True).smem_bytes > wavefront.SMEM_LIMIT
    with pytest.raises(ValueError, match="bytes of shared memory"):
        wavefront.wavefront(torch.zeros(1, m), torch.zeros(64), n=64, w=2,
                            spec=DPSpec(), with_window=True)


def test_hard_limit_counts_the_static_fold_arrays():
    # the card refuses a launch whose dynamic and static shared memory
    # together pass the block's limit: at m 26,913 the dynamic part fits
    # alone, and the kernel's static fold arrays do not
    longest = 26_912
    for m in (longest, longest + 1):
        assert wavefront.hard_geometry(m, False).smem_bytes \
            <= wavefront.SMEM_LIMIT
    wavefront.validate(torch.zeros(1, longest), torch.zeros(64), n=64, w=2,
                       spec=DPSpec())
    with pytest.raises(ValueError, match="bytes of shared memory"):
        wavefront.validate(torch.zeros(1, longest + 1), torch.zeros(64),
                           n=64, w=2, spec=DPSpec())


# ------------------------------------------------- K5/K6 on the ring
@pytest.mark.parametrize("m", [1, 33, 200, PAPER_M])
@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_soft_ring_geometry_is_soft_k7s_and_fits(warps, m):
    geo = wavefront.soft_ring_geometry(m, warps)
    assert geo == family.family_geometry(m, "twed", warps)
    assert geo.smem_bytes + wavefront.STATIC_SMEM <= wavefront.SMEM_LIMIT
    assert warps * (geo.ring_rows - 64) >= m + 31
    assert geo.smem_bytes == (16 * warps * geo.slots + 4 * (m + 64)
                              + 4 * warps * geo.ring_rows)


@pytest.mark.parametrize("m", [1, 33, PAPER_M])
@pytest.mark.parametrize("reverse", [False, True])
def test_soft_ring_model_delivers_and_checkpoints(reverse, m):
    """K5 and the K6 pair walk the hard-min kernel's ring: at 1, P-1, P,
    P+1 and 2P+1 visited chunks (a band-skipped reverse sweep starting
    chunk0 chunks in) every chunk reads, and K6 checkpoints, the column
    its left neighbour wrote (SOFT_BIG for the first).  At PAPER's m the
    smallest ring that completes is two groups below the geometry's:
    three fewer deadlock."""
    geo = wavefront.soft_ring_geometry(m)
    P = geo.warps
    chunk0 = 5 if reverse else 0
    for slots in ((geo.slots, geo.slots - 2) if m == PAPER_M
                  else (geo.slots,)):
        for chunks in (1, P - 1, P, P + 1, 2 * P + 1):
            strips = {}
            read = _simulate_cta(m, chunks, P, slots, chunk0=chunk0,
                                 strips=strips)
            for c in range(chunks):
                want = [(chunk0 + c - 1, i) for i in range(m)] if c else []
                assert read[c] == want, (m, chunks, slots, c)
                assert strips[c] == (want or [SOFT_BIG] * m)
    if m == PAPER_M:
        with pytest.raises(RuntimeError, match="deadlock"):
            _simulate_cta(m, 2 * P + 1, P, geo.slots - 3, chunk0=chunk0)


@pytest.mark.parametrize("kwargs,with_window,longest", [
    ({}, False, 26_912), ({}, True, 18_145), ({"band": 900}, False, 26_912),
    ({"reduction": "softmin"}, False, 26_912),
    ({"family": "twed", "nu": 0.5, "lam": 0.75}, False, 26_912),
    ({"family": "local", "reduction": "softmin", "gap_penalty": 0.6,
      "match_reward": 1.1}, False, 26_912)],
    ids=["K1", "K3", "K4", "K5-K6", "K7-hard", "K7-soft"])
def test_longest_query_is_the_geometry_limit(kwargs, with_window, longest):
    spec = resolve_spec(None, **kwargs)
    assert wavefront.longest_query(spec, with_window=with_window) == longest
    assert wavefront.longest_query(spec, with_window=with_window,
                                   compute_dtype=torch.bfloat16) == longest
    for m, fits in ((longest, True), (longest + 1, False)):
        need = wavefront.block_smem(m, spec, with_window=with_window)
        assert (need <= wavefront.SMEM_LIMIT) == fits
    # the shaped error of the wrappers, before any sweep
    kw = dict(n=64, w=2, spec=spec, with_window=with_window)
    wavefront.validate(torch.zeros(1, longest), torch.zeros(64), **kw)
    with pytest.raises(ValueError, match=f"longest query {longest}"):
        wavefront.validate(torch.zeros(1, longest + 1), torch.zeros(64),
                           **kw)


@pytest.mark.parametrize("rows", [1, 513])
@pytest.mark.parametrize("n", [1, 31, 2000, 2001, 100_000, 100_003,
                               300_000])
def test_k2_geometry_holds_the_row(rows, n):
    geo = normalizer.geometry(rows, n)
    if geo.cluster == 0:
        assert n <= normalizer.ROW_MAX
        assert geo.threads == 32 * normalizer.ROWS_PER_CTA
        assert 32 * 4 * geo.vec >= n > 32 * 4 * geo.vec // 2 or geo.vec == 1
        assert geo.grid * normalizer.ROWS_PER_CTA >= rows
    else:
        assert n > normalizer.ROW_MAX
        assert geo.cluster in (1, 2, 4, 8)
        assert geo.grid == rows * geo.cluster
        if geo.vec:
            assert geo.vec in normalizer.CLUSTER_VECS
            assert geo.cluster * geo.threads * 4 * geo.vec >= n
        else:
            assert n > 8 * 1024 * 4 * max(normalizer.CLUSTER_VECS)


def test_k2_geometry_at_paper():
    assert normalizer.geometry(512, 2000) == (0, 16, 128, 128)
    assert normalizer.geometry(1, 100_000) == (8, 4, 1024, 8)
    with pytest.raises(ValueError, match="empty"):
        normalizer.geometry(0, 5)


# ------------------------------------------------------------- soft K7
FAMS = ("twed", "erp", "local")
FAMILY_PARAMS = dict(nu=0.5, lam=0.75, gap=0.25, gap_penalty=0.6,
                     match_reward=1.1)


@pytest.mark.parametrize("m", [1, 33, 200, PAPER_M])
@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("family_", FAMS)
def test_family_geometry_fits_and_its_ring_delivers(family_, warps, m):
    geo = family.family_geometry(m, family_, warps)
    assert geo.warps == warps and geo.ring_rows == 32 * geo.slots
    assert geo.smem_bytes + wavefront.STATIC_SMEM <= wavefront.SMEM_LIMIT
    assert geo.smem_bytes == (16 * warps * geo.slots + 4 * (m + 64)
                              + 4 * warps * geo.ring_rows)
    # the soft kernel walks the hard-min kernel's ring schedule
    counts = [2 * warps + 1] if m == PAPER_M else _chunk_counts(warps)
    for chunks in counts:
        read = _simulate_cta(m, chunks, warps, geo.slots)
        for c in range(chunks):
            want = [(c - 1, i) for i in range(m)] if c > 0 else []
            assert read[c] == want, (family_, m, chunks, warps, c)


def test_family_geometry_at_paper_and_its_limit():
    for fam in FAMS:
        assert family.family_geometry(PAPER_M, fam).smem_bytes == 19_776
        # both reductions run the same kernel template on the same rings
        hard = resolve_spec(None, family=fam, **FAMILY_PARAMS)
        soft = resolve_spec(None, family=fam, reduction="softmin",
                            gamma=0.7, **FAMILY_PARAMS)
        for m in (1, PAPER_M, 26_912):
            assert wavefront.block_smem(m, hard) \
                == wavefront.block_smem(m, soft) \
                == family.family_geometry(m, fam).smem_bytes \
                + wavefront.STATIC_SMEM <= wavefront.SMEM_LIMIT
        assert wavefront.block_smem(26_913, hard) \
            == wavefront.block_smem(26_913, soft) > wavefront.SMEM_LIMIT
    with pytest.raises(ValueError, match="1 to 8 warps"):
        family.family_geometry(PAPER_M, "local", 9)
    # the longest query the card takes at 8 warps: the dynamic shared
    # memory and the static fold arrays within the block's limit
    for fam in FAMS:
        geo = family.family_geometry(26_912, fam)
        assert geo.smem_bytes + wavefront.STATIC_SMEM <= wavefront.SMEM_LIMIT
        with pytest.raises(ValueError, match="bytes of shared memory"):
            family.family_geometry(26_913, fam)
    m = 20_000        # within the card's limit, and a CPU tensor runs it
    spec = resolve_spec(None, family="erp", reduction="softmin",
                        gamma=0.7, **FAMILY_PARAMS)
    q = torch.zeros(1, m)
    cost, end = family.family_wavefront(q, torch.zeros(64),
                                        (torch.zeros(64), q), n=64, w=2,
                                        spec=spec)
    assert torch.isfinite(cost).all() and end.tolist() == [63]


# The kernel's soft-min, emulated in float32: arguments pre-scaled by
# log2(e)/gamma, the min's own term fixed at 1, the logarithm in base 2
# times gamma*ln 2 (torch's exp2/log2 stand in for MUFU ex2/lg2, whose
# approximation the card's parity cases hold to 1e-4).
def _consts(gamma):
    return (torch.tensor(math.log2(math.e) / gamma, dtype=torch.float32),
            torch.tensor(gamma * math.log(2.0), dtype=torch.float32))


def _kernel_smin3(a, b, c, gamma):
    k2, gl = _consts(gamma)
    lo, hi = torch.minimum(b, c), torch.maximum(b, c)
    mn, o2 = torch.minimum(a, lo), torch.maximum(a, lo)
    s = 1.0 + torch.exp2((mn - hi) * k2) + torch.exp2((mn - o2) * k2)
    return mn - gl * torch.log2(s)


def _kernel_smin0(v, gamma):
    k2, gl = _consts(gamma)
    return torch.minimum(v, torch.zeros_like(v)) \
        - gl * torch.log2(1.0 + torch.exp2(-v.abs() * k2))


def _soft_spec(family_="sdtw", gamma=0.7, distance="sqeuclidean"):
    kw = FAMILY_PARAMS if family_ != "sdtw" else {}
    return resolve_spec(None, family=family_, reduction="softmin",
                        gamma=gamma, distance=distance, **kw)


def _operands(rng, n):
    """Random predecessor values, every tie pattern of three, and the
    SOFT_BIG sentinel in one, two and all three places."""
    x = torch.from_numpy(rng.normal(scale=20.0, size=(n, 3)).astype(
        np.float32))
    pool = (0.0, 0.5, 3.0, SOFT_BIG)
    ties = torch.tensor(list(itertools.product(pool, repeat=3)),
                        dtype=torch.float32)
    return torch.cat([x, ties]).unbind(1)


@pytest.mark.parametrize("gamma", [0.01, 0.7, 5.0])
def test_kernel_soft_min_equals_reduce3_and_reduce2(gamma):
    rng = np.random.default_rng(21)
    a, b, c = _operands(rng, 4000)
    spec = _soft_spec(gamma=gamma)
    got = _kernel_smin3(a, b, c, gamma)
    want = spec.reduce3(a, b, c)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    # the operand order does not matter: the left operand may be any one
    torch.testing.assert_close(_kernel_smin3(c, a, b, gamma), want,
                               rtol=1e-6, atol=1e-5)
    # all three at SOFT_BIG: SOFT_BIG, not NaN
    big = torch.full((4,), SOFT_BIG)
    assert torch.equal(_kernel_smin3(big, big, big, gamma), big)
    v = torch.cat([a, torch.tensor([0.0, -0.0, SOFT_BIG, -3.0])])
    got0 = _kernel_smin0(v, gamma)
    assert torch.isfinite(got0).all()
    torch.testing.assert_close(got0, spec.reduce2(v, torch.zeros_like(v)),
                               rtol=1e-6, atol=1e-5)


def _kernel_family_cell(spec, qv, rv, left, up, upleft, *, i, j, q_prev,
                        r_prev, top, left_bnd):
    """One cell as soft K7 computes it: the column-only t_left and the
    row-only t_up hoisted, the boundaries injected at row -1 and column
    -1 in the order of the kernel's EDGE step, then the base-2 soft-min
    and, for local, the restart floor."""
    g = spec.gamma
    d = spec.cell_cost
    big = torch.tensor(SOFT_BIG)
    zero = torch.zeros(())
    row0, col0 = i == 0, j == 0
    if spec.family == "twed":
        nl = spec.nu + spec.lam
        tl, tup = d(rv, r_prev) + nl, d(qv, q_prev) + nl
        td = (d(qv, rv) + d(q_prev, r_prev)) \
            + (2.0 * spec.nu) * (i - j).abs().float()
        up_b = torch.where(row0, big, up)
        ul_b = torch.where(row0, torch.where(col0, zero, big), upleft)
        left_b = torch.where(col0, big, left)
        ul_b = torch.where(col0 & ~row0, big, ul_b)
    elif spec.family == "erp":
        tl, tup, td = d(rv, spec.gap), d(qv, spec.gap), d(qv, rv)
        up_b = torch.where(row0, top, up)
        ul_b = torch.where(row0, top - tl, upleft)
        left_b = torch.where(col0, left_bnd, left)
        ul_b = torch.where(col0 & ~row0, left_bnd - tup, ul_b)
    else:
        tl = tup = torch.tensor(spec.gap_penalty)
        td = d(qv, rv) - spec.match_reward
        up_b = torch.where(row0, zero, up)
        left_b = torch.where(col0, zero, left)
        ul_b = torch.where(row0 | col0, zero, upleft)
    val = _kernel_smin3(left_b + tl, up_b + tup, ul_b + td, g)
    return _kernel_smin0(val, g) if spec.family == "local" else val


@pytest.mark.parametrize("distance", ["sqeuclidean", "abs"])
@pytest.mark.parametrize("family_", FAMS)
def test_kernel_family_cell_equals_family_cell(family_, distance):
    rng = np.random.default_rng(22)
    n = 3000

    def f32(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(scale=scale, size=shape).astype(
            np.float32))
    spec = _soft_spec(family_, distance=distance)
    qv, rv, q_prev, r_prev = f32(n), f32(n), f32(n), f32(n)
    left, up, upleft = f32(n, scale=30.0), f32(n, scale=30.0), \
        f32(n, scale=30.0)
    # ties, and the sentinel in the neighbours
    up[:300] = left[:300]
    upleft[300:600] = SOFT_BIG
    left[600:700] = SOFT_BIG
    top, left_bnd = f32(n, scale=30.0), f32(n, scale=30.0)
    i = torch.from_numpy(rng.integers(0, 4, size=n))
    j = torch.from_numpy(rng.integers(0, 4, size=n))
    kw = dict(i=i, j=j, q_prev=q_prev, r_prev=r_prev)
    got = _kernel_family_cell(spec, qv, rv, left, up, upleft, top=top,
                              left_bnd=left_bnd, **kw)
    want = spec.family_cell(qv, rv, left, up, upleft, is_row0=i == 0,
                            is_col0=j == 0, top_boundary=top,
                            left_boundary=left_bnd, **kw)
    assert torch.isfinite(got).all()
    assert {(bool(a), bool(b)) for a, b in zip(i == 0, j == 0)} == {
        (False, False), (False, True), (True, False), (True, True)}
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


def _hard_kernel_family_cell(spec, qv, rv, left, up, upleft, *, i, j,
                             q_prev, r_prev, top, left_bnd):
    """One cell as hard K7 computes it, in float32: the constants rounded
    once to float32, the column-only t_left and the row-only t_up
    hoisted, twed's |i - j| as |float(i - j0) - k| (lane column j0,
    k = j - j0 < 8), the boundaries injected at row -1 and column -1 in
    the order of the kernel's EDGE step with the KERNEL_BIG sentinel,
    then fminf(fminf(left, up), upleft) and, for local, fminf(v, 0)."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32)
    d = spec.cell_cost
    big, zero = f32(KERNEL_BIG), f32(0.0)
    row0, col0 = i == 0, j == 0
    if spec.family == "twed":
        nl, two_nu = f32(spec.nu + spec.lam), f32(2.0 * spec.nu)
        tl, tup = d(rv, r_prev) + nl, d(qv, q_prev) + nl
        k = j % 8
        fd = (i - (j - k)).float()
        td = (d(qv, rv) + d(q_prev, r_prev)) \
            + two_nu * (fd - k.float()).abs()
        up_b = torch.where(row0, big, up)
        ul_b = torch.where(row0, torch.where(col0, zero, big), upleft)
        left_b = torch.where(col0, big, left)
        ul_b = torch.where(col0 & ~row0, big, ul_b)
    elif spec.family == "erp":
        g = f32(spec.gap)
        tl, tup, td = d(rv, g), d(qv, g), d(qv, rv)
        up_b = torch.where(row0, top, up)
        ul_b = torch.where(row0, top - tl, upleft)
        left_b = torch.where(col0, left_bnd, left)
        ul_b = torch.where(col0 & ~row0, left_bnd - tup, ul_b)
    else:
        tl = tup = f32(spec.gap_penalty)
        td = d(qv, rv) - f32(spec.match_reward)
        up_b = torch.where(row0, zero, up)
        left_b = torch.where(col0, zero, left)
        ul_b = torch.where(row0 | col0, zero, upleft)
    val = torch.minimum(torch.minimum(left_b + tl, up_b + tup), ul_b + td)
    return torch.minimum(val, zero) if spec.family == "local" else val


@pytest.mark.parametrize("distance", ["sqeuclidean", "abs"])
@pytest.mark.parametrize("family_", FAMS)
def test_hard_kernel_family_cell_equals_family_cell(family_, distance):
    """Hard K7's hoisted cell equals DPSpec.family_cell bit for bit (with
    the kernel's sentinel), at the benchmark's parameters and at
    parameters whose float32 roundings are not exact, over every row 0 /
    column 0 pattern, |i - j| up to a few thousand, ties and KERNEL_BIG
    among the neighbours."""
    rng = np.random.default_rng(25)
    n = 4000

    def f32(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(scale=scale, size=shape).astype(
            np.float32))
    awkward = dict(nu=0.3, lam=0.45, gap=0.3, gap_penalty=0.7,
                   match_reward=1.3)
    for params in (FAMILY_PARAMS, awkward):
        spec = resolve_spec(None, family=family_, distance=distance,
                            **params)
        qv, rv, q_prev, r_prev = f32(n), f32(n), f32(n), f32(n)
        left, up, upleft = (f32(n, scale=30.0) for _ in range(3))
        up[:300] = left[:300]
        upleft[300:600] = KERNEL_BIG
        left[600:700] = KERNEL_BIG
        up[650:750] = KERNEL_BIG
        upleft[650:700] = KERNEL_BIG      # all three: the sentinel back
        top, left_bnd = f32(n, scale=30.0), f32(n, scale=30.0)
        i = torch.from_numpy(np.concatenate([
            rng.integers(0, 4, size=n // 2), rng.integers(0, 5000,
                                                          size=n // 2)]))
        j = torch.from_numpy(np.concatenate([
            rng.integers(0, 4, size=n // 2), rng.integers(0, 5000,
                                                          size=n // 2)]))
        kw = dict(i=i, j=j, q_prev=q_prev, r_prev=r_prev)
        got = _hard_kernel_family_cell(spec, qv, rv, left, up, upleft,
                                       top=top, left_bnd=left_bnd, **kw)
        want = spec.family_cell(qv, rv, left, up, upleft, is_row0=i == 0,
                                is_col0=j == 0, top_boundary=top,
                                left_boundary=left_bnd, big=KERNEL_BIG, **kw)
        assert {(bool(a), bool(b)) for a, b in zip(i == 0, j == 0)} == {
            (False, False), (False, True), (True, False), (True, True)}
        assert torch.equal(got, want)
        if family_ != "local":
            assert (want == torch.tensor(KERNEL_BIG)).any()


def test_twed_diagonal_carry_is_the_previous_steps_distance():
    """twed's d(q_i-1, r_j-1): the kernel carries the lane's own
    d(q, r_j-1) of the previous step (d(0, r) before row 0, the padded
    query's zero), which equals the plain version's d(q_prev, r_prev)
    on every cell, row 0 and column 0 included."""
    rng = np.random.default_rng(23)
    q = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=24).astype(np.float32))
    spec = _soft_spec("twed")
    want = spec.cell_cost(previous_samples(q)[:, None],
                          previous_samples(r)[None, :])
    carried = spec.cell_cost(torch.zeros(()), r)        # row -1
    got = torch.empty_like(want)
    for i in range(q.shape[0]):
        got[i, 0] = spec.cell_cost(previous_samples(q)[i],
                                   torch.zeros(()))      # r[-1] = 0
        got[i, 1:] = carried[:-1]
        carried = spec.cell_cost(q[i], r)
    assert torch.equal(got, want)


def _steady(c, g, *, w, m, n, band):
    """The kernel's steady-block rule (csrc/family_wavefront.cu)."""
    t0 = 32 * g - 1
    cj0 = c * 32 * w
    cj1 = cj0 + 32 * w - 1
    ok = not (c == 0 or cj1 >= n - 1) and g >= 2 and t0 + 31 < m - 1
    if band is not None:
        ok = ok and t0 + 31 - cj0 <= band and cj1 - (t0 - 31) <= band
    return ok


@pytest.mark.parametrize("band", [None, 0, 40, 300])
@pytest.mark.parametrize("m", [1, 33, 64, 200])
def test_steady_blocks_meet_no_edge(m, band):
    """Every cell a steady block computes is a live interior cell of the
    matrix, in band, on a real column: no test of the EDGE step can
    fire there."""
    w = 2
    for n in (1, 63, 64, 65, 300, 700):
        chunks = wavefront.num_chunks(n, w)
        for c in range(chunks):
            for g in range((m + 31 + 1 + 31) // 32):
                if not _steady(c, g, w=w, m=m, n=n, band=band):
                    continue
                t = torch.arange(32 * g - 1, 32 * g + 31)
                lane = torch.arange(32)
                i = (t[:, None] - lane[None, :]).flatten()
                cols = torch.arange(c * 64, (c + 1) * 64)
                assert i.min() >= 1 and i.max() <= m - 2
                assert cols.min() >= 1 and cols.max() <= n - 2
                if band is not None:
                    assert (i[:, None] - cols[None, :]).abs().max() <= band


def _fold_lane(vals, cols, k2):
    """fold_cell of the kernel over one lane's cells, in order."""
    best_v = torch.tensor(SOFT_BIG)
    best_j = 2 ** 31 - 1
    run_m, run_s = torch.tensor(-SOFT_BIG), torch.tensor(0.0)
    for v, j in zip(vals, cols):
        if v < best_v or (v == best_v and j < best_j):
            best_v, best_j = v, int(j)
        x = -v * k2
        d = x - run_m
        e = torch.exp2(-d.abs())
        run_s = run_s * e + 1.0 if d > 0 else run_s + e
        run_m = torch.maximum(run_m, x)
    return best_v, best_j, run_m, run_s


def _merge(a, b):
    """The kernel's merge of two lanes' (or warps') folds."""
    (av, aj, am, as_), (bv, bj, bm, bs) = a, b
    if bv < av or (bv == av and bj < aj):
        av, aj = bv, bj
    mx = torch.maximum(am, bm)
    return av, aj, mx, as_ * torch.exp2(am - mx) + bs * torch.exp2(bm - mx)


@pytest.mark.parametrize("warps", [1, 3, 8])
def test_per_warp_fold_merge_equals_one_logsumexp(warps):
    """Soft local's folds: each lane's running (max, sum) in base 2,
    merged by the shuffle tree of a warp and then across the warps,
    equals one logsumexp of -D/gamma over the same cells, and the
    (value, column) fold is the earliest column of the minimum."""
    gamma = 0.7
    k2, gl = _consts(gamma)
    rng = np.random.default_rng(24)
    lanes = 32 * warps
    per_lane = 40
    vals = torch.from_numpy(rng.normal(scale=3.0, size=(lanes, per_lane))
                            .astype(np.float32)) - 20.0
    vals[5, 7] = vals[70 % lanes, 3] = vals.min() - 1.0     # a tie
    cols = torch.from_numpy(rng.permutation(lanes * per_lane)
                            .reshape(lanes, per_lane))
    counts = torch.from_numpy(rng.integers(0, per_lane + 1, size=lanes))
    if warps > 1:
        counts[-32:] = 0                              # an idle warp
    counts[5] = counts[70 % lanes] = per_lane
    folds = [_fold_lane(vals[lane, :counts[lane]],
                        cols[lane, :counts[lane]], k2)
             for lane in range(lanes)]
    warp_folds = []
    for w in range(warps):
        f = folds[32 * w:32 * (w + 1)]
        for off in (16, 8, 4, 2, 1):                  # __shfl_down_sync
            f = [_merge(f[x], f[x + off]) if x + off < 32 else f[x]
                 for x in range(32)]
        warp_folds.append(f[0])
    total = warp_folds[0]
    for f in warp_folds[1:]:
        total = _merge(total, f)
    best_v, best_j, run_m, run_s = total
    cells = torch.cat([vals[lane, :counts[lane]] for lane in range(lanes)])
    cell_cols = torch.cat([cols[lane, :counts[lane]]
                           for lane in range(lanes)])
    want = -gamma * torch.logsumexp(-cells.double() / gamma, dim=0)
    got = -gl * (run_m + torch.log2(run_s))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert best_v == cells.min()
    assert best_j == int(cell_cols[cells == cells.min()].min())
