"""Fused soft-DTW backward: the checkpointed forward and reverse sweeps
(K6), the tile pass that rebuilds E chunk by chunk, and the
``torch.autograd.Function`` that makes the kernel backend differentiable.

Counterpart of ``repro.kernels.backward``.  With F the forward DP matrix
and B the suffix matrix

    B[i, j] = C[i, j] + smin_gamma(B[i, j+1], B[i+1, j], B[i+1, j+1]),

the expected alignment is

    E[i, j] = d sdtw_gamma / d C[i, j] = exp((cost - F - B + C) / gamma).

* **Sweeps** (:func:`checkpoint_sweeps`): the K6 forward writes each
  visited chunk's entry column of F (a (B, chunks, m) residual, not
  (B, m, N)); the K6 reverse sweep runs B as a forward sweep over the
  flipped queries and the flipped reference, writes its own entry
  columns, and reads out the total cost a second time (a free parity
  check).
* **Tile pass** (:func:`fold_grads`, :func:`soft_alignment_fused`), plain
  torch, as the reference's plain-jnp ``_tile`` / ``_e_tile`` /
  ``_fold_grads``: a few chunks at a time (stacked on the batch axis),
  the F and B tiles are rebuilt from their strips with
  ``wavefront.soft_tile``, E is formed, and the cost gradients are folded
  into (B, m) / (N,) accumulators at once.  E is 0 on padding columns
  (original ``j >= n``) and for queries whose band blocks every
  alignment (cost +inf).  No tensor of B·M·N elements exists on the
  gradient path: the largest is a group of tiles, at most about a
  sixteenth of it where the reference spans many chunks.
* :func:`sdtw_soft_fused` is the kernel backend's soft dispatch.  A
  forward-only call (no grad needed) pays the plain K5 launch and no
  checkpoints; under autograd the :class:`_SoftSDTW` function runs the
  K6 pair and folds tiles in its backward.
"""

from __future__ import annotations

import torch

from repro_torch.core.spec import DPSpec
from repro_torch.kernels import ops, wavefront

TILE_FRACTION = 16
#   A tile group holds at most about n / TILE_FRACTION columns' worth of
#   (B, m, m + W) skewed tiles, so the tile pass stays far below B·M·N
#   elements.


# ------------------------------------------------------------- sweeps
def reference_layouts(reference: torch.Tensor, segment_width: int):
    """(forward, reverse) kernel layouts of a normalized reference."""
    return (ops.prepare_reference(reference, segment_width),
            ops.prepare_reference_reverse(reference, segment_width))


def checkpoint_sweeps(queries: torch.Tensor, reference: torch.Tensor, *,
                      spec: DPSpec, segment_width: int, layouts=None):
    """The K6 pair on (already normalized) queries (B, m) and reference
    (n,).  ``layouts``: the (forward, reverse) reference layouts when
    the caller keeps them (an ``Aligner``), else built here.  Returns
    ``(cost, end, rev_cost, fwd_strips, rev_strips)``: the strips
    (B, chunks, m); ``rev_cost`` is the reverse sweep's own readout,
    equal to ``cost`` up to rounding."""
    w = segment_width
    n = reference.shape[0]
    fwd, rev = layouts or reference_layouts(reference, w)
    cost, end, fck = wavefront.soft_checkpoint(queries, fwd, n=n, w=w,
                                               spec=spec)
    rcost, _, rck = wavefront.soft_checkpoint(
        torch.flip(queries, (1,)).contiguous(), rev, n=n, w=w, spec=spec,
        reverse=True)
    return cost, torch.clamp(end, max=n - 1), rcost, fck, rck


# -------------------------------------------------------------- tiles
def _tile_groups(m: int, n: int, W: int, chunks: int):
    """[c0, c1) ranges of chunks, a few at a time (see TILE_FRACTION)."""
    K = max(1, min(chunks, n // (TILE_FRACTION * (m + W))))
    for c0 in range(0, chunks, K):
        yield c0, min(chunks, c0 + K)


def _e_tiles(qn, rp, cost, fck, rck, c0: int, c1: int, *, spec: DPSpec,
             n: int, W: int, R: int):
    """E and the (q - r) differences of forward chunks [c0, c1), stacked
    on the batch axis: both (B, c1 - c0, m, W)."""
    B, m = qn.shape
    K = c1 - c0
    Gf = fck.shape[1]
    dev = qn.device
    rc = rp[c0 * W:c1 * W].reshape(K, W)
    diff = qn[:, None, :, None] - rc[None, :, None, :]      # (B, K, m, W)
    C = spec.cell_cost(qn[:, None, :, None], rc[None, :, None, :])
    cols = torch.arange(c0 * W, c1 * W, device=dev).reshape(K, W)

    def stacked(x):                  # (B, K, ...) -> (B * K, ...)
        return x.reshape(B * K, *x.shape[2:])

    def valid_of(cols_, shift, reverse, jlim):
        v = torch.stack([wavefront.tile_valid(m, c, spec, jlim=jlim,
                                              shift=shift, reverse=reverse)
                         for c in cols_])
        return v[None].expand(B, -1, -1, -1).reshape(B * K, m, W)

    F = wavefront.soft_tile(stacked(C), valid_of(cols, 0, False, n),
                            stacked(fck[:, c0:c1]), spec=spec,
                            reverse=False)
    # the B tiles in flipped coordinates: forward chunk c is flipped
    # chunk R-1-c, whose strip is reverse strip Gf-1-c
    n_pad = R * W
    rcols = n_pad - 1 - torch.flip(cols, (1,))
    Bt = wavefront.soft_tile(
        stacked(torch.flip(C, (2, 3))),
        valid_of(rcols, m - n_pad, True, n_pad - n),
        stacked(torch.flip(rck[:, Gf - c1:Gf - c0], (1,))), spec=spec,
        reverse=True)
    Bo = torch.flip(Bt, (1, 2)).reshape(B, K, m, W)
    F = F.reshape(B, K, m, W)
    E = torch.exp((cost[:, None, None, None] - F - Bo + C) / spec.gamma)
    live = torch.isfinite(cost)[:, None, None, None] & (cols < n)[None, :,
                                                                  None, :]
    return torch.where(live, E, 0.0), diff


def fold_grads(queries: torch.Tensor, layout: torch.Tensor, n: int,
               cost: torch.Tensor, fck: torch.Tensor, rck: torch.Tensor,
               ct: torch.Tensor, *, spec: DPSpec, segment_width: int):
    """Fold ct-weighted E tiles into (d cost / d queries, d cost /
    d reference), group by group.  ``layout``: the forward reference
    layout the K6 forward swept (reference length ``n``)."""
    B, m = queries.shape
    W = wavefront.chunk_cols(segment_width)
    rp = layout
    R = rp.shape[0] // W
    Gf = fck.shape[1]
    ctw = ct.to(torch.float32)[:, None, None, None]
    gq = torch.zeros((B, m), dtype=torch.float32, device=queries.device)
    gr = torch.zeros((R * W,), dtype=torch.float32, device=queries.device)
    for c0, c1 in _tile_groups(m, n, W, Gf):
        E, diff = _e_tiles(queries, rp, cost, fck, rck, c0, c1, spec=spec,
                           n=n, W=W, R=R)
        if spec.distance == "sqeuclidean":
            g = (2.0 * ctw) * E * diff           # dC/dq = 2 (q - r)
        else:
            g = ctw * E * torch.sign(diff)       # dC/dq = sign(q - r)
        gq += g.sum(dim=(1, 3))
        gr[c0 * W:c1 * W] = -g.sum(dim=(0, 2)).reshape(-1)  # dC/dr = -dC/dq
    return gq, gr[:n]


def soft_alignment_fused(queries: torch.Tensor, reference: torch.Tensor, *,
                         spec: DPSpec, segment_width: int = 8,
                         layouts=None):
    """(cost (B,), end (B,), E (B, M, N)) from one K6 pair and the tile
    pass.  E itself is the requested B·M·N output; everything upstream
    of it stays tiled.  Inputs are not normalized here; ``layouts`` as
    in :func:`checkpoint_sweeps`."""
    wavefront.check_plan(spec, kernel="soft")
    q = queries.to(torch.float32).contiguous()
    r = reference.to(torch.float32).contiguous()
    B, m = q.shape
    n = r.shape[0]
    if ops.band_blocked(m, n, spec.band):
        return (torch.full((B,), float("inf"), device=q.device),
                torch.zeros((B,), dtype=torch.int32, device=q.device),
                torch.zeros((B, m, n), device=q.device))
    w = segment_width
    W = wavefront.chunk_cols(w)
    layouts = layouts or reference_layouts(r, w)
    cost, end, _, fck, rck = checkpoint_sweeps(q, r, spec=spec,
                                               segment_width=w,
                                               layouts=layouts)
    rp = layouts[0]
    R = rp.shape[0] // W
    E = torch.zeros((B, m, R * W), device=q.device)
    for c0, c1 in _tile_groups(m, n, W, fck.shape[1]):
        Et, _ = _e_tiles(q, rp, cost, fck, rck, c0, c1, spec=spec, n=n,
                         W=W, R=R)
        E[:, :, c0 * W:c1 * W] = Et.permute(0, 2, 1, 3).reshape(B, m, -1)
    return cost, end, E[:, :, :n]


# ------------------------------------------------------------ autograd
class _SoftSDTW(torch.autograd.Function):
    """(queries, reference) -> (cost, end) through the K6 pair; the
    backward folds tiles (plain torch) into both gradients."""

    @staticmethod
    def forward(ctx, queries, reference, spec, segment_width, layouts):
        B, m = queries.shape
        n = reference.shape[0]
        ctx.spec, ctx.segment_width = spec, segment_width
        if ops.band_blocked(m, n, spec.band):
            ctx.blocked = True
            cost = torch.full((B,), float("inf"), device=queries.device)
            end = torch.zeros((B,), dtype=torch.int32,
                              device=queries.device)
        else:
            ctx.blocked = False
            layouts = layouts or reference_layouts(reference, segment_width)
            cost, end, _, fck, rck = checkpoint_sweeps(
                queries, reference, spec=spec, segment_width=segment_width,
                layouts=layouts)
            ctx.save_for_backward(queries, cost, fck, rck)
            ctx.layout = layouts[0]
        ctx.shapes = (queries.shape, reference.shape)
        ctx.mark_non_differentiable(end)
        return cost, end

    @staticmethod
    def backward(ctx, ct, _ct_end):
        if ctx.blocked:
            qs, rs = ctx.shapes
            dev = ct.device
            return (torch.zeros(qs, device=dev), torch.zeros(rs, device=dev),
                    None, None, None)
        queries, cost, fck, rck = ctx.saved_tensors
        gq, gr = fold_grads(queries, ctx.layout, ctx.shapes[1][0], cost,
                            fck, rck, ct, spec=ctx.spec,
                            segment_width=ctx.segment_width)
        return gq, gr, None, None, None


def sdtw_soft_fused(queries: torch.Tensor, reference: torch.Tensor, *,
                    spec: DPSpec, segment_width: int = 8, layouts=None):
    """Soft-min sDTW (cost, end) through the soft kernels, differentiable
    by the fused reverse-sweep backward.  queries (B, M), reference (N,),
    not normalized here; ``layouts`` as in :func:`checkpoint_sweeps`.  Without autograd (grad disabled, or no input
    that requires grad) this is one plain K5 launch; with it, the K6
    pair runs and the tile pass folds the gradients."""
    wavefront.check_plan(spec, kernel="soft")
    q = queries.to(torch.float32).contiguous()
    r = reference.to(torch.float32).contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or r.requires_grad):
        return _SoftSDTW.apply(q, r, spec, int(segment_width), layouts)
    return ops.sdtw_wavefront(q, r, segment_width=segment_width, spec=spec)
