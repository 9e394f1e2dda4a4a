"""The design of the port's hard-min wavefront and K2 kernels, on the CPU:
the reassociated cell of ``csrc/wavefront.cu`` against the port's
``DPSpec.cell_update`` / ``start3``, a step-by-step model of the kernel's
mbarrier ring between the warps of a CTA (every row arrives at the right
chunk, no geometry deadlocks), and the host helpers that size the hard-min
launch and K2's grid and cluster."""
import itertools

import pytest
import torch

from repro_torch.core.spec import DPSpec, KERNEL_BIG
from repro_torch.kernels import normalizer, wavefront

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
def _simulate_cta(m: int, chunks: int, warps: int, slots: int):
    """Run the CTA's schedule of wavefront.cu step by step, the warps in
    turn, with each mbarrier a count of completed phases and each wait a
    test of its phase parity, as ``mbarrier.try_wait.parity`` tests it.
    Returns the boundary rows each chunk read, {chunk: [(chunk, row),
    ...]}; raises when no warp can take a step (a deadlock)."""
    G = wavefront.RING_GROUP
    groups = -(-m // G)
    full = [[0] * slots for _ in range(warps)]      # [link][slot]
    empty = [[0] * slots for _ in range(warps)]
    data = [[None] * (slots * G) for _ in range(warps)]
    read = {c: [] for c in range(chunks)}

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
            if has_in:
                while not full_done(link_in, in0):
                    yield False
                rd = in0 % slots
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
                    if has_out and g - 1 < groups:
                        while not empty_done(link_out, out0 + g - 1):
                            yield False
                        wr = (out0 + g - 1) % slots
                if rd is not None and t + 1 < m:        # lane 0 reads t+1
                    read[c].append(data[link_in][rd * G + (t + 1) % G])
                i = t - 31                               # lane 31 writes i
                if has_out and 0 <= i < m:
                    data[link_out][wr * G + i % G] = (c, i)
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
