// Batched subsequence DTW wavefronts for Hopper (sm_90a).
//
// Replaces: repro/kernels/wavefront.py::wavefront_call (pallas_call body
// _generic_kernel) under the sdtw plans.  Two kernels, one per library:
//   * hard-min (this file built as libwavefront): MinArgminFold (K1), the
//     int32 start channel with_window=True (K3), and the Sakoe–Chiba band
//     with band-skip (K4).  One template, instantiated over (segment
//     width W, window, band, distance).
//   * soft-min (this file built with -DREPRO_SOFT as libsoft_wavefront,
//     see the second half): SoftMinFold (K5), its checkpoint=True
//     boundary strips and its reverse=True sweep (K6), on the hard-min
//     kernel's multi-warp design with soft cells.
//   * bf16-K1 (the hard-min half built with -DREPRO_BF16 as
//     libwavefront_bf16): K1/K3/K4 under compute_dtype=bfloat16
//     (CarryChannel.reg_dtype, :132-134), see bf16() below.
// The three libraries are compiled by three nvcc processes side by side.
//
// The hard-min kernel.  What bounds it on an H100: operations.  Every one
// of the B*M*N cells costs a subtract, a multiply (or an abs), two mins and
// an add, and reads nothing from device memory (the query row sits in
// shared memory, the W reference samples in registers).  Bytes moved are
// negligible: B*M + N floats in, three numbers per query out.
//
// Design: the paper's two levels, shuffles inside a wavefront and shared
// memory between consecutive wavefronts.
//   * One CTA of P warps (blockDim = 32 * P, P <= 8) per query.  The
//     reference is cut into chunks of 32*W columns; lane l of the warp
//     that sweeps chunk c owns the W consecutive columns
//     c*32*W + l*W + k (k < W) and holds their reference samples and the
//     previous row's W cell values in registers (the paper's thread
//     coarsening).  Within a chunk the warp sweeps the anti-diagonal: at
//     step t lane l computes query row i = t - l, so the left neighbour of
//     its first cell is lane l-1's last cell of the same row, computed one
//     step earlier, which arrives by __shfl_up_sync (the TPU kernel's
//     pltpu.roll).
//   * The chunks are dealt to the warps round-robin: warp p sweeps chunks
//     p, p+P, p+2P, ...  Lane 31's last cell of each row of chunk c (its
//     right boundary column) is chunk c+1's left boundary.  It goes from
//     warp c mod P to warp (c+1) mod P through a shared-memory ring, one
//     ring per link (warp p reads ring p and writes ring (p+1) mod P), in
//     groups of 32 rows.  Each group slot has a full and an empty
//     mbarrier (arrival count 1): lane 31 of the producer arrives on full
//     after storing the group's rows, lane 0 of the consumer arrives on
//     empty after its last read of the group, and the whole warp waits
//     with try_wait.parity.  A warp meets its ring waits and arrivals once
//     every 32 steps, at the steps t = 31 (mod 32), where both its
//     consumer group (row t+1 is the first row of group (t+1)/32) and its
//     producer group (row t-31 is the first of group (t-31)/32) change;
//     it walks each link's stream of groups with a (slot, phase) cursor.
//     Consecutive chunks start about (m+31)/P steps apart, so a ring of
//     ceil((m+31)/(32P)) + 2 groups lets no warp wait in the steady state,
//     and the P rings together hold about one column of m rows.  With
//     much smaller rings every warp can end up waiting on a full ring (a
//     deadlock); tests/test_torch_wavefront_design.py runs this schedule
//     on a model of the mbarriers and finds the smallest ring that
//     completes two groups below this one.  In each ring step the arrives
//     come before the waits.  The last chunk writes no ring and chunk 0
//     reads none; a
//     warp left with no chunk (chunks < P) touches no mbarrier and meets
//     its CTA only at the final __syncthreads.  Sizes come from the host
//     (kernels/wavefront.py::hard_geometry).  The mbarrier helpers, the
//     Ring / Cursor types and the walk itself (RingWalk) live in
//     csrc/ring.cuh, shared with the soft-min half of this file (K5/K6)
//     and the soft-min K7 of csrc/family_wavefront.cu.
//   * The query row is staged once in shared memory, padded by 32 zeros
//     on each side so that rows outside [0, m) need no clamp; each lane
//     loads its next step's sample one step ahead, as lane 0 does its
//     next left neighbour from the ring.
//   * A cell is pre = min(up, upleft), off the chain, then
//     val = cost + min(left, pre): one min and one add wait for the left
//     neighbour.  min is exact and associative on these operands (no NaN,
//     no -0: every cost and sum is >= +0), so val equals
//     cost + min(min(left, up), upleft) bit for bit.  The start lane
//     follows: spre = upleft < up ? s_upleft : s_up, then
//     s = pre < left ? spre : s_left, which is start3's strict-< rule,
//     ties included (tests/test_torch_wavefront_design.py).
//   * Row tests belong to blocks of steps, not cells.  The steps run in
//     blocks of 32 (block g: t = 32g - 1 + u, u < 32), each opened by the
//     ring step; lane 0 reads index u of its consumer slot and lane 31
//     writes index u of its producer slot.  Lane l meets row 0 at step l
//     and row m-1 at step m-1+l, so only the first two blocks and the
//     last one or two test row 0 (the free start), the fold of row m-1
//     (strict < over ascending columns, and j < n, which only the last
//     chunk can fail) and the ring rows outside [0, m); the steady blocks
//     between them test nothing.
//   * At the end each lane's (value, column, start) fold is merged by
//     shuffles within the warp and through shared memory across the CTA,
//     lexicographically on (value, column): the earliest column wins a
//     tie.
// Exactness: cells round as the plain version does ((q-r)*(q-r) with
// __fmul_rn, no fused multiply-add, then __fadd_rn), and min is exact, so
// on identical inputs cost, end and start equal the plain version bit for
// bit.  Columns j >= n (the tail of the last chunk) are computed from the
// zero padding and never folded; they only feed columns to their right.
// Cells of rows outside [0, m) are computed and never used.  Band-skip:
// the host passes only the chunks holding a column <= (M-1) + band.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

}  // namespace

#ifndef REPRO_SOFT

#ifdef REPRO_BF16
#include <cuda_bf16.h>
#endif

// 1: a __syncwarp() ends every step (see the step's end).  0 drops it;
// built only to time the barrier (scripts/wavefront_variants.py).
#ifndef REPRO_STEP_SYNCWARP
#define REPRO_STEP_SYNCWARP 1
#endif

namespace {

constexpr float kBig = 3.0e38f;   // KERNEL_BIG of repro/core/spec.py
constexpr int kNoWindow = -1;     // NO_WINDOW
constexpr int kMaxWarps = 8;      // warps per CTA (kernels/wavefront.py)
constexpr int kQPad = 32;         // zeros each side of the staged query

// The compute type.  Under -DREPRO_BF16 every operand and every cell
// operation's float32 result is rounded to bf16 (round to nearest even),
// which is what torch's bf16 ops do (compute in float32, round), so the
// cells, the carries and the ring hold bf16 values and equal the plain
// version (the engine in bf16) bit for bit; they stay in 32-bit
// registers, and the fold compares them as float32, as the JAX plan's
// MinArgminFold does.  The float32 build's bf16() is the identity.
__device__ __forceinline__ float bf16(float x) {
#ifdef REPRO_BF16
  return __bfloat162float(__float2bfloat16_rn(x));
#else
  return x;
#endif
}

// One warp's registers: its W columns of the current chunk, the carries
// of the anti-diagonal, and its running fold.
template <int W, bool WINDOW>
struct Lane {
  float rv[W];      // reference samples of my W columns
  float prev[W];    // row i-1 of my W cells
  int sprev[W];
  float left, upleft, qv;
  int sleft, supleft;
  float best_v;
  int best_j, best_s;
};

// What one step reads and writes outside the warp's registers: the ring
// slots (RingIO, csrc/ring.cuh) and qrow, the staged query at
// sq + kQPad + 1 - lane, so qrow[t] is my next step's sample.
struct StepIO : RingIO {
  const float* qrow;
};

// One step of one chunk: lane l computes row i = t - l of its W columns.
// EDGE: a block of steps that may meet row 0 (t < 32), row m-1 (the last
// 32 steps) or rows outside [0, m) at the ring; every test is on.  A
// steady block (EDGE false) tests nothing.
template <int W, bool WINDOW, bool BAND, bool ABS, bool EDGE>
__device__ __forceinline__ void step(Lane<W, WINDOW>& L, int t, int u,
                                     int lane, int j0, int m, int n,
                                     int band, const StepIO& io) {
  const int i = t - lane;
  const float qv = L.qv;
  L.qv = io.qrow[t];                        // next step's sample
  float next_left = kBig;                   // lane 0's next left neighbour
  int next_sleft = kNoWindow;
  if (io.reads && (!EDGE || t + 1 < m)) {
    next_left = io.rd[u];
    if (WINDOW) next_sleft = io.srd[u];
  }
  float lft = L.left, ul = L.upleft;
  int slft = L.sleft, sul = L.supleft;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = j0 + k;
    const float d = bf16(__fsub_rn(qv, L.rv[k]));
    const float cst = ABS ? fabsf(d) : bf16(__fmul_rn(d, d));
    const float up = L.prev[k];
    const float pre = fminf(up, ul);        // off the chain
    float val = bf16(__fadd_rn(cst, fminf(lft, pre)));
    int s = 0;
    if (WINDOW) {
      const int spre = (ul < up) ? sul : L.sprev[k];
      s = (pre < lft) ? spre : slft;
    }
    if (EDGE && i == 0) {
      val = cst;                            // free start: D[-1, j] = 0
      if (WINDOW) s = j;
    }
    if (BAND && abs(i - j) > band) {
      val = kBig;                           // out of band: never folded
      if (WINDOW) s = kNoWindow;
    }
    ul = up;
    L.prev[k] = val;
    lft = val;
    if (WINDOW) {
      sul = L.sprev[k];
      L.sprev[k] = s;
      slft = s;
    }
  }
  if (EDGE && i == m - 1) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int j = j0 + k;
      if (j < n && (!BAND || abs(i - j) <= band) && L.prev[k] < L.best_v) {
        L.best_v = L.prev[k];
        L.best_j = j;
        if (WINDOW) L.best_s = L.sprev[k];
      }
    }
  }
  // my last cell is the left neighbour of lane+1's first cell next step
  const float from_left = __shfl_up_sync(kFull, lft, 1);
  int sfrom_left = 0;
  if (WINDOW) sfrom_left = __shfl_up_sync(kFull, slft, 1);
  if (io.writes && (!EDGE || (i >= 0 && i < m))) {
    io.wr[u] = lft;
    if (WINDOW) io.swr[u] = slft;
  }
  L.upleft = L.left;
  L.supleft = L.sleft;
  if (lane == 0) {
    L.left = next_left;
    if (WINDOW) L.sleft = next_sleft;
  } else {
    L.left = from_left;
    if (WINDOW) L.sleft = sfrom_left;
  }
#if REPRO_STEP_SYNCWARP
  // Kept from the one-warp kernel: without a per-step barrier nvcc 12.8
  // (-O3, sm_90a) split that kernel's step loop into a copy for chunk 0
  // and one for later chunks, and the chunk-0 copy stored lane 31's
  // column at the wrong strip address.  scripts/wavefront_variants.py
  // builds this file without it and times both (PERF.md §7).
  __syncwarp();
#endif
}

template <int W, bool WINDOW, bool BAND, bool ABS>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
wavefront_kernel(const float* __restrict__ q, const float* __restrict__ r,
                 int m, int n, int chunks, int band, int slots,
                 float* __restrict__ cost_out, int* __restrict__ end_out,
                 int* __restrict__ start_out) {
  // [warps][slots][2] mbarriers | query [m + 64] f32 | rings [warps]
  // [slots * 32] f32 | (window) rings [warps][slots * 32] i32
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float fold_v[kMaxWarps];
  __shared__ int fold_j[kMaxWarps], fold_s[kMaxWarps];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ring_rows = slots * kGroup;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* sq = reinterpret_cast<float*>(bars + 2 * warps * slots);
  float* ring_v = sq + m + 2 * kQPad;
  int* ring_s = reinterpret_cast<int*>(ring_v + warps * ring_rows);

  const float* qb = q + static_cast<size_t>(blockIdx.x) * m;
  for (int x = threadIdx.x; x < m + 2 * kQPad; x += blockDim.x) {
    const int i = x - kQPad;
    sq[x] = (i >= 0 && i < m) ? bf16(qb[i]) : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2 * warps * slots; ++k) mbar_init(bars + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto ring = [&](int link) {
    return Ring{ring_v + link * ring_rows,
                WINDOW ? ring_s + link * ring_rows : nullptr,
                bars + 2 * link * slots};
  };
  RingWalk<WINDOW> walk{ring(warp), ring((warp + 1) % warps), slots,
                        (m + kGroup - 1) / kGroup, lane};

  Lane<W, WINDOW> L;
  L.best_v = INFINITY;
  L.best_j = 0;
  L.best_s = kNoWindow;
  StepIO io;
  io.qrow = sq + kQPad + 1 - lane;

  for (int c = warp; c < chunks; c += warps) {
    walk.open_chunk(c, chunks, io);
    const int j0 = (c * 32 + lane) * W;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      L.rv[k] = bf16(r[j0 + k]);
      L.prev[k] = kBig;
      L.sprev[k] = kNoWindow;
    }
    L.left = kBig;                          // column -1 edge sentinel
    L.sleft = kNoWindow;
    if (walk.first_group(io) && lane == 0) {
      L.left = io.rd[0];
      if (WINDOW) L.sleft = io.srd[0];
    }
    L.upleft = kBig;
    L.supleft = kNoWindow;
    L.qv = sq[kQPad - lane];

    // blocks of 32 steps, opened by the ring step (RingWalk)
    for (int g = 0; 32 * g - 1 < m + 31; ++g) {
      const int t0 = 32 * g - 1;
      if (g > 0) walk.open_block(g, io);
      if (g >= 2 && t0 + 31 < m - 1) {      // no row 0, no row m-1
#pragma unroll 4
        for (int u = 0; u < kGroup; ++u)
          step<W, WINDOW, BAND, ABS, false>(L, t0 + u, u, lane, j0, m, n,
                                            band, io);
      } else {
        const int u1 = min(kGroup, m + 31 - t0);
        for (int u = g == 0 ? 1 : 0; u < u1; ++u)
          step<W, WINDOW, BAND, ABS, true>(L, t0 + u, u, lane, j0, m, n,
                                           band, io);
      }
    }
    walk.close_chunk();
  }

  // lexicographic (value, column) merge: the earliest column wins, first
  // across the lanes of each warp, then across the warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, L.best_v, off);
    const int oj = __shfl_down_sync(kFull, L.best_j, off);
    const int os = __shfl_down_sync(kFull, L.best_s, off);
    if (ov < L.best_v || (ov == L.best_v && oj < L.best_j)) {
      L.best_v = ov;
      L.best_j = oj;
      L.best_s = os;
    }
  }
  if (lane == 0) {
    fold_v[warp] = L.best_v;
    fold_j[warp] = L.best_j;
    fold_s[warp] = L.best_s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = fold_v[0];
    int bj = fold_j[0], bs = fold_s[0];
    for (int p = 1; p < warps; ++p) {
      if (fold_v[p] < bv || (fold_v[p] == bv && fold_j[p] < bj)) {
        bv = fold_v[p];
        bj = fold_j[p];
        bs = fold_s[p];
      }
    }
    cost_out[blockIdx.x] = bv;
    end_out[blockIdx.x] = bj;
    if (WINDOW) start_out[blockIdx.x] = bs;
  }
}

// Dynamic shared memory of one CTA; kernels/wavefront.py::hard_geometry
// computes the same number.
size_t smem_bytes(int m, int warps, int slots, bool window) {
  const size_t ring = static_cast<size_t>(warps) * slots * kGroup;
  return 16 * static_cast<size_t>(warps) * slots +
         4 * (static_cast<size_t>(m) + 2 * kQPad) + (window ? 8 : 4) * ring;
}

template <int W, bool WINDOW, bool BAND, bool ABS>
int launch(const float* q, const float* r, int batch, int m, int n,
           int chunks, int band, int warps, int slots, float* cost, int* end,
           int* start, cudaStream_t stream) {
  const size_t smem = smem_bytes(m, warps, slots, WINDOW);
  auto kernel = wavefront_kernel<W, WINDOW, BAND, ABS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, 32 * warps, smem, stream>>>(q, r, m, n, chunks, band, slots,
                                              cost, end, start);
  return static_cast<int>(cudaGetLastError());
}

template <int W, bool WINDOW, bool BAND, bool ABS>
int occupancy(int m, int warps, int slots) {
  const size_t smem = smem_bytes(m, warps, slots, WINDOW);
  auto kernel = wavefront_kernel<W, WINDOW, BAND, ABS>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      32 * warps, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// op 0: launch; op 1: CTAs resident per SM (returned, or -error)
template <int W>
int dispatch(int op, const float* q, const float* r, int batch, int m, int n,
             int chunks, int band, int window, int abs_dist, int warps,
             int slots, float* cost, int* end, int* start, cudaStream_t s) {
  const bool banded = band >= 0;
#define REPRO_CASE(WIN, BND, ABSD)                                          \
  if (!!window == WIN && banded == BND && !!abs_dist == ABSD)               \
    return op == 0 ? launch<W, WIN, BND, ABSD>(q, r, batch, m, n, chunks,   \
                                               band, warps, slots, cost,    \
                                               end, start, s)               \
                   : occupancy<W, WIN, BND, ABSD>(m, warps, slots);
  REPRO_CASE(false, false, false)
  REPRO_CASE(false, false, true)
  REPRO_CASE(false, true, false)
  REPRO_CASE(false, true, true)
  REPRO_CASE(true, false, false)
  REPRO_CASE(true, false, true)
  REPRO_CASE(true, true, false)
  REPRO_CASE(true, true, true)
#undef REPRO_CASE
  return op == 0 ? static_cast<int>(cudaErrorInvalidValue)
                 : -static_cast<int>(cudaErrorInvalidValue);
}

int hard_entry(int op, const void* q, const void* r, int batch, int m, int n,
               int chunks, int band, int width, int window, int abs_dist,
               int warps, int slots, void* cost, void* end, void* start,
               void* stream) {
  const int bad = op == 0 ? static_cast<int>(cudaErrorInvalidValue)
                          : -static_cast<int>(cudaErrorInvalidValue);
  if (warps < 1 || warps > kMaxWarps || slots < 1) return bad;
  const float* qf = static_cast<const float*>(q);
  const float* rf = static_cast<const float*>(r);
  float* c = static_cast<float*>(cost);
  int* e = static_cast<int*>(end);
  int* st = static_cast<int*>(start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_WIDTH(WD)                                                     \
  case WD:                                                                  \
    return dispatch<WD>(op, qf, rf, batch, m, n, chunks, band, window,     \
                        abs_dist, warps, slots, c, e, st, s);
  switch (width) {
    REPRO_WIDTH(2)
    REPRO_WIDTH(4)
    REPRO_WIDTH(8)
    REPRO_WIDTH(14)
    REPRO_WIDTH(16)
    REPRO_WIDTH(32)
    default: return bad;
  }
#undef REPRO_WIDTH
}

}  // namespace

extern "C" {

// q: (batch, m) f32; r: (chunks_total * 32 * width,) f32, zero-padded past
// n; the kernel visits the first `chunks` chunks.  band < 0: unbanded.
// warps: warps per CTA (1..8); slots: ring groups of 32 rows per link
// (kernels/wavefront.py::hard_geometry).  cost (batch,) f32, end (batch,)
// i32, start (batch,) i32 (window only).  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a width with no instantiation).
int wavefront_launch(const void* q, const void* r, int batch, int m, int n,
                     int chunks, int band, int width, int window,
                     int abs_dist, int warps, int slots, void* cost,
                     void* end, void* start, void* stream) {
  return hard_entry(0, q, r, batch, m, n, chunks, band, width, window,
                    abs_dist, warps, slots, cost, end, start, stream);
}

// CTAs of the instantiation resident per SM at this geometry, or a
// negative CUDA error code.
int wavefront_occupancy(int m, int width, int window, int banded,
                        int abs_dist, int warps, int slots) {
  return hard_entry(1, nullptr, nullptr, 0, m, 0, 0, banded ? 0 : -1, width,
                    window, abs_dist, warps, slots, nullptr, nullptr,
                    nullptr, nullptr);
}

}  // extern "C"

#endif  // !REPRO_SOFT

#ifdef REPRO_SOFT

// ---------------------------------------------------------------------
// Soft-min sweeps: K5 (SoftMinFold), K6 (checkpoint and reverse plans).
//
// Replaces: repro/kernels/wavefront.py::wavefront_call under the soft-min
// KernelPlan (SoftMinFold, :242-300; big = SOFT_BIG, :539-543), with
// checkpoint=True (:768-777, output :929-936) and reverse=True (:683-700,
// band shift and block offset :609-628), as driven by
// repro/kernels/backward.py::_checkpoint_sweeps.
//
// What bounds it on an H100: the special-function units.  Every cell is
// cost + smin(left, up, upleft), a min-shifted logsumexp whose own term is
// exp(0) = 1, so two exponentials and one logarithm a cell, issued by 16
// MUFU lanes per SM per clock against 128 FP32 lanes.  Bytes moved are
// small: the queries, the reference, three numbers per query and, for K6,
// one checkpoint column of m floats per visited chunk.
//
// Design: the hard-min kernel's (first half of this file), with soft
// cells.
//   * One CTA of P warps (P <= 8) per query; the visited chunks
//     [chunk0, chunk0 + chunks) are dealt to the warps round-robin (warp p
//     sweeps visited chunks chunk0 + p, chunk0 + p + P, ...), lane l of
//     the warp that sweeps chunk c owns columns c*32*W + l*W + k, and at
//     step t computes row i = t - l.  Lane 31's last cell of each row goes
//     to the next chunk's warp through the shared-memory ring of
//     csrc/ring.cuh (32-row groups, a full/empty mbarrier pair each, one
//     f32 a row), walked by RingWalk as K1/K3 and K7 walk it: in each
//     ring step the arrivals come before the waits, the last visited chunk
//     writes no ring and the first reads none, a warp with no chunk
//     touches no mbarrier.  Lane 0 keeps its upleft as the previous step's
//     left.  Sizes come from the host (kernels/wavefront.py::
//     soft_ring_geometry).
//   * The query (flipped for the reverse sweep) is staged once in shared
//     memory, padded with 32 zeros on each side; each lane loads its next
//     step's sample one step ahead.
//   * The soft-min is csrc/softmin.cuh's, shared with soft K7: the min's
//     own term fixed at 1, two MUFU ex2.approx and one lg2.approx a cell
//     on arguments pre-scaled by log2(e)/gamma (-DREPRO_EXACT_SOFTMIN:
//     full accuracy).  Sentinel SOFT_BIG = 1e30 everywhere (prev[] init,
//     lane 0's column -1, out-of-band and pad cells), finite, so that no
//     inf - inf enters the soft-min.
//   * Blocks of 32 steps, opened by the ring step.  A block is steady when
//     it meets neither row 0 nor row m-1 (nor rows outside [0, m)), its
//     chunk holds no reverse padding, and (banded) every cell of the
//     block lies in the band.  Steady blocks carry no row, pad, band or
//     fold test; the others (EDGE) test everything.
//   * Folds: each lane keeps a running base-2 logsumexp pair (max, scaled
//     sum) of -D[m-1, j] * log2(e)/gamma over its bottom-row cells,
//     rescaled only when its max moves (one exponential a cell), beside
//     the hard (value, column) twin that gives `end` and detects a blocked
//     band (best >= SOFT_BIG/2 -> +inf).  After the sweep both are merged
//     by shuffles within each warp and through shared memory across the
//     warps: the earliest column wins a tie, the pairs by the running-max
//     rule; cost = best - gamma * ln 2 * log2(sum), the minimum read out
//     exactly (the soft-DTW gradient divides cost errors by gamma).
//   * Checkpoint (ckpt != nullptr, K6): the column entering visited chunk
//     c is exactly what the chunk's lane 0 reads from the ring.  Each
//     group of 32 rows is written to ckpt[b, c, :] by the whole warp,
//     coalesced, as the group is taken from the ring; the first visited
//     chunk writes SOFT_BIG.
//   * REVERSE: B[i,j] = C[i,j] + smin(B[i,j+1], B[i+1,j], B[i+1,j+1]) run as
//     a forward sweep over flipped queries x the flipped, left-padded
//     reference.  The forward boundary rules are mirrored, not re-used:
//     flipped row 0 has no up operand and its upleft slot is the 0-weight
//     termination, flipped row m-1 has no left operand (so m == 1 gives
//     B == C).  Flipped columns j < jlim are padding (original j >= n):
//     they are masked to SOFT_BIG, since the flipped left neighbour of the
//     real column n-1 IS a pad column.  The band test shifts by
//     shift = m - n_pad (original i - j = shift - (i' - j')), and the host
//     skips the leading flipped chunks that the band leaves empty
//     (chunk0).  The reverse cost readout folds flipped row m-1 (original
//     row 0) over the real columns: it equals the forward cost.
// Columns of the forward sweep at j >= jlim (= n) are computed from the
// zero padding and never folded; they only feed columns to their right.
// Exactness: the soft cells are not bit-equal to the plain version (the
// transcendentals round differently; where they underflow, as at small
// gamma, the cells agree bit for bit); they are held to it within
// atol = rtol = 1e-4, with equal ends.

#include "softmin.cuh"

namespace {

constexpr float kSoftBig = 1e30f;   // SOFT_BIG of repro/core/spec.py
constexpr int kMaxWarps = 8;        // warps per CTA (kernels/wavefront.py)
constexpr int kQPad = 32;           // zeros each side of the staged query

struct SoftParams {
  float k2;      // log2(e) / gamma: exp(-x / gamma) = exp2(-x * k2)
  float gl;      // gamma * ln 2: gamma * log(s) = gl * log2(s)
};

// One warp's registers: its W columns of the current chunk, the carries
// of the anti-diagonal, and its running folds.
template <int W>
struct SoftLane {
  float rv[W];      // reference samples of my W columns
  float prev[W];    // row i-1 of my W cells
  float left, upleft, qv;
  float best_v;     // hard twin: (value, column) minimum
  int best_j;
  float run_m, run_s;  // running logsumexp pair, base 2
};

// What one step reads and writes outside the warp's registers: the ring
// slots (RingIO, csrc/ring.cuh) and qrow, the staged query at
// sq + kQPad + 1 - lane, so qrow[t] is my next step's sample.
struct SoftStepIO : RingIO {
  const float* qrow;
};

// A bottom-row cell into the lane's folds: the (value, column) minimum
// (columns arrive in ascending order, so strict < keeps the earliest),
// and the running logsumexp of -val * k2, rescaled only when its max
// moves.
template <int W>
__device__ __forceinline__ void fold_cell(SoftLane<W>& L, float val, int j,
                                          const SoftParams& p) {
  if (val < L.best_v) {
    L.best_v = val;
    L.best_j = j;
  }
  const float x = -__fmul_rn(val, p.k2);    // rounded as the readout's
  const float d = x - L.run_m;
  const float e = ex2(-fabsf(d));
  L.run_s = d > 0.f ? fmaf(L.run_s, e, 1.f) : L.run_s + e;
  L.run_m = fmaxf(L.run_m, x);
}

// One step of one chunk: lane l computes row i = t - l of its W columns.
// EDGE: every row, pad, band and fold test is on; a steady block (EDGE
// false) tests nothing.  The cell rounds cost + smin as the plain version
// rounds cost + reduce3 (__fmul_rn / __fadd_rn, no fused multiply-add):
// where the soft terms underflow (small gamma) the two agree bit for bit,
// which the gradient's E = exp((cost - F - B + C) / gamma) needs.
template <int W, bool REVERSE, bool BAND, bool ABS, bool EDGE>
__device__ __forceinline__ void soft_step(SoftLane<W>& L, int t, int u,
                                          int lane, int j0, int m, int jlim,
                                          int band, int shift,
                                          const SoftStepIO& io,
                                          const SoftParams& p) {
  const int i = t - lane;
  const float qv = L.qv;
  L.qv = io.qrow[t];                        // next step's sample
  float next_left = kSoftBig;               // lane 0's next left neighbour
  if (io.reads && (!EDGE || t + 1 < m)) next_left = io.rd[u];
  float lft = L.left, ul = L.upleft;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = j0 + k;
    const float d = qv - L.rv[k];
    const float cst = ABS ? fabsf(d) : __fmul_rn(d, d);
    const float up = L.prev[k];
    float val;
    if (!EDGE) {
      val = __fadd_rn(cst, smin3(lft, up, ul, p.k2, p.gl));
    } else if (REVERSE) {
      val = __fadd_rn(cst, smin3(i == m - 1 ? kSoftBig : lft,
                                 i == 0 ? kSoftBig : up, i == 0 ? 0.f : ul,
                                 p.k2, p.gl));
      if (j < jlim) val = kSoftBig;         // padding: original j >= n
    } else {
      // free start: D[-1, j] = 0
      val = i == 0 ? cst
                   : __fadd_rn(cst, smin3(lft, up, ul, p.k2, p.gl));
    }
    if (EDGE) {
      if (BAND && abs(i - j - shift) > band) {
        val = kSoftBig;                     // out of band: never folded
      } else if (i == m - 1 && (REVERSE ? j >= jlim : j < jlim)) {
        fold_cell(L, val, j, p);
      }
    }
    ul = up;
    L.prev[k] = val;
    lft = val;
  }
  // my last cell is the left neighbour of lane+1's first cell next step
  const float from_left = __shfl_up_sync(kFull, lft, 1);
  if (io.writes && (!EDGE || (i >= 0 && i < m))) io.wr[u] = lft;
  L.upleft = L.left;
  L.left = lane == 0 ? next_left : from_left;
  // the hard-min kernel's per-step barrier, kept for the same reason
  __syncwarp();
}

// K6: the warp copies the ring group it has just taken (rows 32g ..
// 32g + 31 of the column entering its chunk) to the chunk's strip.
__device__ __forceinline__ void checkpoint_group(float* strip, int g,
                                                 int lane, int m,
                                                 const float* rd) {
  const int row = g * kGroup + lane;
  if (row < m) strip[row] = rd[lane];
}

template <int W, bool REVERSE, bool BAND, bool ABS>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
soft_wavefront_kernel(const float* __restrict__ q,
                      const float* __restrict__ r, int m, int jlim,
                      int chunk0, int chunks, int band, int shift, int slots,
                      SoftParams p, float* __restrict__ cost_out,
                      int* __restrict__ end_out, float* __restrict__ ckpt) {
  // [warps][slots][2] mbarriers | query [m + 64] f32 | rings [warps]
  // [slots * 32] f32
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float fold_v[kMaxWarps], fold_m[kMaxWarps], fold_s[kMaxWarps];
  __shared__ int fold_j[kMaxWarps];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ring_rows = slots * kGroup;
  const int padded = m + 2 * kQPad;
  const int groups = (m + kGroup - 1) / kGroup;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* sq = reinterpret_cast<float*>(bars + 2 * warps * slots);
  float* ring_v = sq + padded;

  const float* qb = q + static_cast<size_t>(blockIdx.x) * m;
  for (int x = threadIdx.x; x < padded; x += blockDim.x) {
    const int i = x - kQPad;
    sq[x] = (i >= 0 && i < m) ? qb[i] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2 * warps * slots; ++k) mbar_init(bars + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto ring = [&](int link) {
    return Ring{ring_v + link * ring_rows, nullptr, bars + 2 * link * slots};
  };
  RingWalk<false> walk{ring(warp), ring((warp + 1) % warps), slots, groups,
                       lane};

  SoftLane<W> L;
  L.best_v = kSoftBig;
  L.best_j = 0;
  L.run_m = -kSoftBig;                      // finite: no -inf - -inf
  L.run_s = 0.f;
  SoftStepIO io;
  io.qrow = sq + kQPad + 1 - lane;

  // c: the visited chunk (0 .. chunks-1), chunk0 + c the layout's chunk
  for (int c = warp; c < chunks; c += warps) {
    walk.open_chunk(c, chunks, io);
    const int cj0 = (chunk0 + c) * 32 * W, cj1 = cj0 + 32 * W - 1;
    const int j0 = cj0 + lane * W;
    // the reverse sweep's padding lies in its first layout chunk
    const bool edge_chunk = REVERSE && cj0 < jlim;
    float* strip = ckpt == nullptr
                       ? nullptr
                       : ckpt + (static_cast<size_t>(blockIdx.x) * chunks + c) *
                                    static_cast<size_t>(m);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      L.rv[k] = r[j0 + k];
      L.prev[k] = kSoftBig;
    }
    L.left = kSoftBig;                      // column -1 edge sentinel
    if (walk.first_group(io)) {
      if (lane == 0) L.left = io.rd[0];
      if (strip != nullptr) checkpoint_group(strip, 0, lane, m, io.rd);
    } else if (strip != nullptr) {
      for (int x = lane; x < m; x += 32) strip[x] = kSoftBig;
    }
    L.upleft = kSoftBig;
    L.qv = sq[kQPad - lane];

    // blocks of 32 steps, opened by the ring step (RingWalk)
    for (int g = 0; 32 * g - 1 < m + 31; ++g) {
      const int t0 = 32 * g - 1;
      if (g > 0) {
        walk.open_block(g, io);
        if (strip != nullptr && walk.has_in && g < groups)
          checkpoint_group(strip, g, lane, m, io.rd);
      }
      // rows t0-31 .. t0+31 meet neither row 0 nor row m-1; under a band,
      // every cell of the block is in it
      bool steady = !edge_chunk && g >= 2 && t0 + 31 < m - 1;
      if (BAND)
        steady = steady && t0 + 31 - cj0 - shift <= band &&
                 cj1 + shift - (t0 - 31) <= band;
      if (steady) {
#pragma unroll 2
        for (int u = 0; u < kGroup; ++u)
          soft_step<W, REVERSE, BAND, ABS, false>(L, t0 + u, u, lane, j0, m,
                                                  jlim, band, shift, io, p);
      } else {
        const int u1 = min(kGroup, m + 31 - t0);
        for (int u = g == 0 ? 1 : 0; u < u1; ++u)
          soft_step<W, REVERSE, BAND, ABS, true>(L, t0 + u, u, lane, j0, m,
                                                 jlim, band, shift, io, p);
      }
    }
    walk.close_chunk();
  }

  // merge the lanes of each warp by shuffles, then the warps through
  // shared memory: lexicographic (value, column) for the hard twin, the
  // running-max rule for the logsumexp pairs
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, L.best_v, off);
    const int oj = __shfl_down_sync(kFull, L.best_j, off);
    const float om = __shfl_down_sync(kFull, L.run_m, off);
    const float os = __shfl_down_sync(kFull, L.run_s, off);
    if (ov < L.best_v || (ov == L.best_v && oj < L.best_j)) {
      L.best_v = ov;
      L.best_j = oj;
    }
    const float mx = fmaxf(L.run_m, om);
    L.run_s = L.run_s * exp2f(L.run_m - mx) + os * exp2f(om - mx);
    L.run_m = mx;
  }
  if (lane == 0) {
    fold_v[warp] = L.best_v;
    fold_j[warp] = L.best_j;
    fold_m[warp] = L.run_m;
    fold_s[warp] = L.run_s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float bv = fold_v[0], rm = fold_m[0], rs = fold_s[0];
  int bj = fold_j[0];
  for (int w = 1; w < warps; ++w) {
    if (fold_v[w] < bv || (fold_v[w] == bv && fold_j[w] < bj)) {
      bv = fold_v[w];
      bj = fold_j[w];
    }
    const float mx = fmaxf(rm, fold_m[w]);
    rs = rs * exp2f(rm - mx) + fold_s[w] * exp2f(fold_m[w] - mx);
    rm = mx;
  }
  // -gamma ln 2 (rm + log2(rs)) with the minimum read out exactly: rm is
  // the best cell's -bv * k2, rounded as fold_cell rounded it, so
  // rm + bv * k2 is 0 and bv stands for -gl * rm without the rounding of
  // gl * k2 (up to 1e-7 relative, which E multiplies by 1 / gamma); only
  // the soft correction goes through gl
  cost_out[blockIdx.x] =
      bv >= 0.5f * kSoftBig
          ? INFINITY
          : bv - p.gl * (log2f(rs) + (rm + __fmul_rn(bv, p.k2)));
  end_out[blockIdx.x] = bj;
}

// Dynamic shared memory of one CTA; kernels/wavefront.py::
// soft_ring_geometry computes the same number.
size_t soft_smem_bytes(int m, int warps, int slots) {
  return 16 * static_cast<size_t>(warps) * slots +
         4 * (static_cast<size_t>(m) + 2 * kQPad) +
         4 * static_cast<size_t>(warps) * slots * kGroup;
}

// What an entry asks of an instantiation: op 0 launches, op 1 returns the
// CTAs resident per SM (or -error).
struct SoftCall {
  int op;
  const float *q, *r;
  int batch, m, jlim, chunk0, chunks, band, shift, warps, slots;
  SoftParams p;
  float* cost;
  int* end;
  float* ckpt;
  cudaStream_t stream;
};

template <int W, bool REVERSE, bool BAND, bool ABS>
int soft_run(const SoftCall& a) {
  const size_t smem = soft_smem_bytes(a.m, a.warps, a.slots);
  auto kernel = soft_wavefront_kernel<W, REVERSE, BAND, ABS>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess)
      return a.op == 0 ? static_cast<int>(err) : -static_cast<int>(err);
  }
  if (a.op == 1) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        32 * a.warps, smem);
    return err == cudaSuccess ? blocks : -static_cast<int>(err);
  }
  kernel<<<a.batch, 32 * a.warps, smem, a.stream>>>(
      a.q, a.r, a.m, a.jlim, a.chunk0, a.chunks, a.band, a.shift, a.slots,
      a.p, a.cost, a.end, a.ckpt);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int soft_dispatch(const SoftCall& a, int reverse, int abs_dist) {
  const bool banded = a.band >= 0;
#define REPRO_CASE(REV, BND, ABSD)                                          \
  if (!!reverse == REV && banded == BND && !!abs_dist == ABSD)              \
    return soft_run<W, REV, BND, ABSD>(a);
  REPRO_CASE(false, false, false)
  REPRO_CASE(false, false, true)
  REPRO_CASE(false, true, false)
  REPRO_CASE(false, true, true)
  REPRO_CASE(true, false, false)
  REPRO_CASE(true, false, true)
  REPRO_CASE(true, true, false)
  REPRO_CASE(true, true, true)
#undef REPRO_CASE
  return -1;
}

int soft_entry(const SoftCall& a, int width, int reverse, int abs_dist) {
  const int bad = a.op == 0 ? static_cast<int>(cudaErrorInvalidValue)
                            : -static_cast<int>(cudaErrorInvalidValue);
  if (a.warps < 1 || a.warps > kMaxWarps || a.slots < 1) return bad;
  int status = -1;
  switch (width) {
    case 2: status = soft_dispatch<2>(a, reverse, abs_dist); break;
    case 4: status = soft_dispatch<4>(a, reverse, abs_dist); break;
    case 8: status = soft_dispatch<8>(a, reverse, abs_dist); break;
    case 14: status = soft_dispatch<14>(a, reverse, abs_dist); break;
    case 16: status = soft_dispatch<16>(a, reverse, abs_dist); break;
    case 32: status = soft_dispatch<32>(a, reverse, abs_dist); break;
    default: break;
  }
  return status == -1 ? bad : status;
}

}  // namespace

extern "C" {

// q: (batch, m) f32 (rows flipped for reverse); r: the layout, chunks of
// 32 * width columns, zero-padded (forward: past n; reverse: the flipped
// reference left-padded); the kernel visits chunks [chunk0, chunk0 +
// chunks).  jlim: forward, the true length n (fold j < n); reverse, the
// pad width n_pad - n (columns j < jlim masked).  band < 0: unbanded;
// shift: 0 forward, m - n_pad reverse.  warps: warps per CTA (1..8);
// slots: ring groups of 32 rows per link (kernels/wavefront.py::
// soft_ring_geometry).  cost (batch,) f32, end (batch,) i32, ckpt
// (batch, chunks, m) f32 or null.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a width or geometry with no instantiation).
int soft_wavefront_launch(const void* q, const void* r, int batch, int m,
                          int jlim, int chunk0, int chunks, int band,
                          int shift, float gamma, int width, int reverse,
                          int abs_dist, int warps, int slots, void* cost,
                          void* end, void* ckpt, void* stream) {
  // the base-2 constants, formed in double and rounded once
  const double g = gamma;
  const SoftParams p{static_cast<float>(1.4426950408889634 / g),
                     static_cast<float>(g * 0.6931471805599453)};
  const SoftCall a{0, static_cast<const float*>(q),
                   static_cast<const float*>(r), batch, m, jlim, chunk0,
                   chunks, band, shift, warps, slots, p,
                   static_cast<float*>(cost), static_cast<int*>(end),
                   static_cast<float*>(ckpt),
                   static_cast<cudaStream_t>(stream)};
  return soft_entry(a, width, reverse, abs_dist);
}

// CTAs of the instantiation resident per SM at this geometry, or a
// negative CUDA error code.
int soft_wavefront_occupancy(int m, int width, int reverse, int banded,
                             int abs_dist, int warps, int slots) {
  const SoftCall a{1, nullptr, nullptr, 0, m, 0, 0, 0, banded ? 0 : -1, 0,
                   warps, slots, SoftParams{}, nullptr, nullptr, nullptr,
                   nullptr};
  return soft_entry(a, width, reverse, abs_dist);
}

}  // extern "C"

#endif  // REPRO_SOFT

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
