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
//     boundary strips and its reverse=True sweep (K6).  It keeps the
//     one-warp-per-query design with a double-buffered strip that its
//     own comment describes.
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
//     csrc/ring.cuh, shared with the soft-min K7 of
//     csrc/family_wavefront.cu.
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
// cost + mn - g*log(exp((mn-a)/g) + exp((mn-b)/g) + exp((mn-c)/g)), with
// mn the min of its three predecessors.  The min's own term is exp(0) = 1,
// so the function needs two exponentials and a logarithm (this kernel
// evaluates all three expf), issued by 16 MUFU lanes per SM per clock
// against 128 FP32 lanes.  Bytes moved are small (the queries, the reference, three numbers
// per query and, for K6, one checkpoint column per chunk).
//
// Design: the hard kernel's (one warp per query, W cells per lane in
// registers, __shfl_up_sync for the left neighbour, a double-buffered
// shared-memory strip for the chunk boundary), with:
//   * sentinel SOFT_BIG = 1e30 everywhere (prev[] init, lane 0's column -1,
//     out-of-band and pad cells), finite so that -SOFT_BIG/g stays finite
//     and no inf - inf enters the min-shifted logsumexp;
//   * expf / logf, CUDA's full-accuracy library functions (not the
//     __expf / __logf intrinsics): the kernel is held to the plain version
//     within 1e-4, the bar the JAX package holds its soft kernel to;
//   * fold: each lane keeps a running (max, scaled sum) of -D[m-1, j]/g
//     over its bottom-row cells, merged across the warp by shuffles into
//     -g*(max + log(sum)), beside the hard (value, column) twin that gives
//     `end` (earliest column on a tie) and detects a blocked band
//     (best >= SOFT_BIG/2 -> +inf);
//   * checkpoint (ckpt != nullptr): at the start of each chunk the warp
//     copies the strip it is about to read, the previous chunk's last
//     column (SOFT_BIG for the first chunk), to ckpt[b, c, :];
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
// Exactness: the soft cells are not bit-equal to the plain version
// (transcendentals and fused multiply-adds round differently); the plain
// version agrees within 1e-4.

namespace {

constexpr float kSoftBig = 1e30f;   // SOFT_BIG of repro/core/spec.py

__device__ __forceinline__ float softmin3(float a, float b, float c,
                                          float gamma, float inv_gamma) {
  const float mn = fminf(fminf(a, b), c);
  const float s = expf((mn - a) * inv_gamma) + expf((mn - b) * inv_gamma) +
                  expf((mn - c) * inv_gamma);
  return mn - gamma * logf(s);
}

template <int W, bool REVERSE, bool BAND, bool ABS>
__global__ void __launch_bounds__(32)
soft_wavefront_kernel(const float* __restrict__ q,
                      const float* __restrict__ r, int m, int jlim,
                      int chunk0, int chunks, int band, int shift,
                      float gamma, float* __restrict__ cost_out,
                      int* __restrict__ end_out, float* __restrict__ ckpt) {
  extern __shared__ float strip[];            // [2][m]
  const int lane = threadIdx.x;
  const float* qb = q + static_cast<size_t>(blockIdx.x) * m;
  const float inv_gamma = 1.0f / gamma;

  float prev[W];                              // row i-1 of my W cells
  float best_v = kSoftBig;                    // hard twin: end, blocked
  int best_j = 0;
  float run_m = -kSoftBig, run_s = 0.f;       // running logsumexp pair

  for (int c = 0; c < chunks; ++c) {
    const int j0 = ((chunk0 + c) * 32 + lane) * W;
    float rv[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      rv[k] = r[j0 + k];
      prev[k] = kSoftBig;
    }
    const float* rd = strip + (c & 1) * m;
    float* wr = strip + ((c + 1) & 1) * m;
    if (ckpt != nullptr) {
      float* out = ckpt + (static_cast<size_t>(blockIdx.x) * chunks + c) * m;
      for (int i = lane; i < m; i += 32) out[i] = c > 0 ? rd[i] : kSoftBig;
    }

    float left = (lane == 0 && c > 0) ? rd[0] : kSoftBig;
    float upleft = kSoftBig;

    for (int t = 0; t < m + 31; ++t) {
      const int i = t - lane;
      const float qv = qb[min(max(i, 0), m - 1)];
      float lft = left, ul = upleft;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int j = j0 + k;
        const float d = qv - rv[k];
        const float cst = ABS ? fabsf(d) : d * d;
        const float up = prev[k];
        float val;
        if (REVERSE) {
          val = cst + softmin3(i == m - 1 ? kSoftBig : lft,
                               i == 0 ? kSoftBig : up, i == 0 ? 0.f : ul,
                               gamma, inv_gamma);
          if (j < jlim) val = kSoftBig;       // padding: original j >= n
        } else {
          // free start: D[-1, j] = 0
          val = i == 0 ? cst : cst + softmin3(lft, up, ul, gamma, inv_gamma);
        }
        if (BAND && abs(i - j - shift) > band) {
          val = kSoftBig;                     // out of band: never folded
        } else if (i == m - 1 && (REVERSE ? j >= jlim : j < jlim)) {
          if (val < best_v) {                 // strict: earliest column
            best_v = val;
            best_j = j;
          }
          const float x = -val * inv_gamma;
          const float mx = fmaxf(run_m, x);
          run_s = run_s * expf(run_m - mx) + expf(x - mx);
          run_m = mx;
        }
        ul = up;
        prev[k] = val;
        lft = val;
      }
      // my last cell is the left neighbour of lane+1's first cell next step
      const float from_left = __shfl_up_sync(kFull, lft, 1);
      if (lane == 31 && i >= 0 && i < m) wr[i] = lft;
      upleft = left;
      if (lane == 0) {
        left = (c > 0 && t + 1 < m) ? rd[t + 1] : kSoftBig;
      } else {
        left = from_left;
      }
      // The per-step barrier of the hard kernel, kept for the same reason:
      // without it nvcc 12.8 miscompiled the strip store there.
      __syncwarp();
    }
    __syncwarp();
  }

  // merge the lanes: lexicographic (value, column) for the hard twin, the
  // running-max rule for the logsumexp pairs
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, best_v, off);
    const int oj = __shfl_down_sync(kFull, best_j, off);
    const float om = __shfl_down_sync(kFull, run_m, off);
    const float os = __shfl_down_sync(kFull, run_s, off);
    if (ov < best_v || (ov == best_v && oj < best_j)) {
      best_v = ov;
      best_j = oj;
    }
    const float mx = fmaxf(run_m, om);
    run_s = run_s * expf(run_m - mx) + os * expf(om - mx);
    run_m = mx;
  }
  if (lane == 0) {
    cost_out[blockIdx.x] = best_v >= 0.5f * kSoftBig
                               ? INFINITY
                               : -gamma * (run_m + logf(run_s));
    end_out[blockIdx.x] = best_j;
  }
}

template <int W, bool REVERSE, bool BAND, bool ABS>
int soft_launch(const float* q, const float* r, int batch, int m, int jlim,
                int chunk0, int chunks, int band, int shift, float gamma,
                float* cost, int* end, float* ckpt, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(m);
  auto kernel = soft_wavefront_kernel<W, REVERSE, BAND, ABS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, 32, smem, stream>>>(q, r, m, jlim, chunk0, chunks, band,
                                      shift, gamma, cost, end, ckpt);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int soft_dispatch(const float* q, const float* r, int batch, int m, int jlim,
                  int chunk0, int chunks, int band, int shift, float gamma,
                  int reverse, int abs_dist, float* cost, int* end,
                  float* ckpt, cudaStream_t s) {
  const bool banded = band >= 0;
#define REPRO_CASE(REV, BND, ABSD)                                          \
  if (!!reverse == REV && banded == BND && !!abs_dist == ABSD)              \
    return soft_launch<W, REV, BND, ABSD>(q, r, batch, m, jlim, chunk0,     \
                                          chunks, band, shift, gamma, cost, \
                                          end, ckpt, s);
  REPRO_CASE(false, false, false)
  REPRO_CASE(false, false, true)
  REPRO_CASE(false, true, false)
  REPRO_CASE(false, true, true)
  REPRO_CASE(true, false, false)
  REPRO_CASE(true, false, true)
  REPRO_CASE(true, true, false)
  REPRO_CASE(true, true, true)
#undef REPRO_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q: (batch, m) f32 (rows flipped for reverse); r: the layout, chunks of
// 32 * width columns, zero-padded (forward: past n; reverse: the flipped
// reference left-padded); the kernel visits chunks [chunk0, chunk0 +
// chunks).  jlim: forward, the true length n (fold j < n); reverse, the
// pad width n_pad - n (columns j < jlim masked).  band < 0: unbanded;
// shift: 0 forward, m - n_pad reverse.  cost (batch,) f32, end (batch,)
// i32, ckpt (batch, chunks, m) f32 or null.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a width with no instantiation).
int soft_wavefront_launch(const void* q, const void* r, int batch, int m,
                          int jlim, int chunk0, int chunks, int band,
                          int shift, float gamma, int width, int reverse,
                          int abs_dist, void* cost, void* end, void* ckpt,
                          void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* rf = static_cast<const float*>(r);
  float* c = static_cast<float*>(cost);
  int* e = static_cast<int*>(end);
  float* ck = static_cast<float*>(ckpt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_WIDTH(WD)                                                      \
  case WD:                                                                   \
    return soft_dispatch<WD>(qf, rf, batch, m, jlim, chunk0, chunks, band,  \
                             shift, gamma, reverse, abs_dist, c, e, ck, s);
  switch (width) {
    REPRO_WIDTH(2)
    REPRO_WIDTH(4)
    REPRO_WIDTH(8)
    REPRO_WIDTH(14)
    REPRO_WIDTH(16)
    REPRO_WIDTH(32)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_WIDTH
}

}  // extern "C"

#endif  // REPRO_SOFT

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
