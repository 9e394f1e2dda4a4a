// The recurrence-family wavefront (K7) for Hopper (sm_90a).
//
// Replaces: repro/kernels/wavefront.py::wavefront_call (pallas_call body
// _generic_kernel) under the family plans: KernelPlan.cell through
// DPSpec.family_cell (:670-681, repro/core/spec.py:373), the extra
// operands r_prev / bt / bl (:95-99, :797-831) and the folds CornerFold
// (twed, erp; :304-337), LocalCellsFold (local; :341-385) and
// SoftCellsFold (soft local; :389-442).  One kernel template, built twice
// by two nvcc side by side, the reduction chosen at compile time:
//   * hard-min, -fmad=false (libfamily_wavefront): min, exact;
//   * soft-min, -DREPRO_SOFT (libsoft_family_wavefront): the MUFU
//     soft-min of csrc/softmin.cuh.
// Each build instantiates family_kernel over (segment width W, family,
// band, distance) and exports the same entries, the soft build's named
// soft_family_wavefront_*.
//
// What bounds it on an H100: operations.  Every one of the B*M*N cells
// computes the family's three transition costs, its boundary injections
// and a three-way reduction (plus the local restart floor and, for local,
// a fold on every cell); under soft-min the reductions are logsumexps,
// whose exponentials and logarithms issue on the special-function units
// (MUFU, 16 lanes per SM per clock against 128 FP32 lanes).  Bytes moved
// are small: the queries, the reference and one extra operand in, two
// numbers per query out.  One warp per query leaves the per-step chain
// exposed (a load, the cell chain, a shuffle and a barrier a step), so a
// query runs as one CTA of P warps (the hard-min design of
// csrc/wavefront.cu):
//
//   * Chunks of 32*W columns are dealt to the warps round-robin; lane l of
//     the warp that sweeps chunk c owns columns c*32*W + l*W + k and at
//     step t computes row i = t - l.  Lane 31's last cell of each row goes
//     to the next chunk's warp through the shared-memory ring of
//     csrc/ring.cuh (32-row groups, a full/empty mbarrier pair each, one
//     f32 a row: K7 has no start lane), walked by RingWalk: in each ring
//     step the arrivals come before the waits, the last chunk writes no
//     ring and chunk 0 reads none, a warp with no chunk touches no
//     mbarrier.  Lane 0 keeps its upleft as the previous step's left.
//     Sizes come from the host (kernels/family.py::family_geometry).
//   * The query is staged once in shared memory, padded with 32 zeros on
//     each side (the zero at index -1 is twed's q[-1] = 0, with no
//     branch); each lane loads its next step's sample one step ahead.
//     erp's bl[b, i] (column -1) is read by one lane, lane 0 of chunk 0,
//     from global memory one step ahead.
//   * Row-only and column-only terms are hoisted out of the cell: twed's
//     t_left = d(r_j, r_j-1) + nu + lam and erp's d(r_j, g) once per column
//     per chunk, in registers; twed's t_up = d(q_i, q_i-1) + nu + lam and
//     erp's d(q_i, g) once per step.  twed's diagonal term
//     d(q_i-1, r_j-1) is the lane's own d(q, r) of column j-1 one step
//     earlier, carried in registers (the same operands, so the same
//     value), and |i - j| is one int-to-float conversion a step.
//   * Blocks of 32 steps, opened by the ring step.  A block is steady when
//     it meets neither row 0 nor row m-1 (nor rows outside [0, m)), its
//     chunk holds neither column 0 nor column n-1 nor padding, and
//     (banded) every cell of the block lies in the band.  Steady blocks
//     carry no row, column, live, band or fold edge test; the others
//     (EDGE) test everything, as family_cell does.
//   * Hard-min: reduce3 is fminf(fminf(left, up), upleft) and local's
//     floor fminf(v, 0), as the plain version orders them.  Soft-min:
//     csrc/softmin.cuh's, shared with K5/K6 (the min's own term fixed at
//     1, two MUFU ex2.approx and one lg2.approx a reduce3, one and one a
//     reduce2, on arguments pre-scaled by log2(e)/gamma); the two operands
//     that do not depend on the left neighbour (up, upleft) are ordered off
//     the chain.
//
// Folds.  Corner (twed, erp): the lane that computes (m-1, n-1) keeps it;
// a corner >= kBig/2 (blocked band) gives (+inf, end 0).  Cells (local):
// every cell with 0 <= i < m, j < n and value < kBig/2 enters a per-lane
// lexicographic (value, column) minimum, merged across the lanes by
// shuffles and across the warps through shared memory; under soft-min a
// running logsumexp of -D/gamma (base 2, rescaled only when its running
// max moves) rides beside it.  The j < n guard matters: the layout pads
// with 0, a plausible sample, and a local cell on a pad column can score
// better than every real one.
//
// Exactness.  Hard-min: every operation is the plain version's, in its
// operand order, rounded as it rounds (__fsub_rn / __fmul_rn /
// __fadd_rn where a product meets a sum, and no fused multiply-add
// anywhere under -fmad=false; min is exact).  The hoists are exact:
// the same operands give the same roundings, and |i - j| as
// fabsf(float(i - j0) - k) is exact below 2^24.  The constants nu + lam,
// 2 nu, g, gap_penalty and match_reward arrive as f32 rounded once from
// double, as torch rounds the plain version's Python scalars.  Every
// in-band cell of twed and erp is reachable from the origin and every
// local cell has the 0 boundary, so the sentinel KERNEL_BIG never wins a
// valid cell's min and the kernel equals the engine (which uses +inf) bit
// for bit.  Soft-min: held to the plain version within atol = rtol =
// 1e-4, with equal ends (transcendentals and fused multiply-adds round
// differently); its sentinel SOFT_BIG = 1e30 is finite, so exp2 of
// -SOFT_BIG*log2(e)/gamma is 0, never NaN.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "ring.cuh"
#include "softmin.cuh"

#ifdef REPRO_SOFT
#define REPRO_ENTRY(name) soft_##name
#else
#define REPRO_ENTRY(name) name
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTwed = 0, kErp = 1, kLocal = 2;
#ifdef REPRO_SOFT
constexpr bool kSoft = true;
constexpr float kBig = 1e30f;      // SOFT_BIG of repro/core/spec.py
#else
constexpr bool kSoft = false;
constexpr float kBig = 3.0e38f;    // KERNEL_BIG
#endif
constexpr int kMaxWarps = 8;      // warps per CTA (kernels/wavefront.py)
constexpr int kQPad = 32;         // zeros each side of the staged query

struct Params {
  float nl;      // nu + lam (twed)
  float two_nu;  // 2 nu (twed)
  float gap;     // g (erp)
  float gp;      // gap_penalty (local)
  float mr;      // match_reward (local)
  float k2;      // soft: log2(e) / gamma, exp(-x / gamma) = exp2(-x * k2)
  float gl;      // soft: gamma * ln 2, gamma * log(s) = gl * log2(s)
};

template <bool ABS>
__device__ __forceinline__ float dist(float a, float b) {
  const float d = __fsub_rn(a, b);
  return ABS ? fabsf(d) : __fmul_rn(d, d);
}

// a + b * c: rounded twice in the hard build, as the plain version rounds
// it; the soft build lets the compiler fuse it
__device__ __forceinline__ float add_mul(float a, float b, float c) {
  if constexpr (kSoft) return a + b * c;
  return __fadd_rn(a, __fmul_rn(b, c));
}

// DPSpec.reduce3: a the left operand (on the chain), b and c up and
// upleft
__device__ __forceinline__ float reduce3(float a, float b, float c,
                                         const Params& p) {
  if constexpr (kSoft) return smin3(a, b, c, p.k2, p.gl);
  return fminf(fminf(a, b), c);
}

// DPSpec.reduce2(v, 0), local's restart floor; under soft-min
// min(v, 0) - gamma * log(1 + exp(-|v| / gamma))
__device__ __forceinline__ float floor0(float v, const Params& p) {
  if constexpr (kSoft)
    return fmaf(-p.gl, lg2(1.f + ex2(-fabsf(v) * p.k2)), fminf(v, 0.f));
  return fminf(v, 0.f);
}

// One warp's registers: its W columns of the current chunk, the carries
// of the anti-diagonal, and its running folds.
template <int W>
struct Lane {
  float rv[W];      // reference samples of my W columns
  float tl[W];      // t_left of my columns (twed, erp)
  float xv[W];      // erp: bt[j], the row -1 boundary
  float dd[W];      // twed: d(q, r_j) of the previous step
  float prev[W];    // row i-1 of my W cells
  float x0;         // twed: r[j0 - 1]
  float left, upleft, qv, qp;
  float bl;         // erp, lane 0 of chunk 0: bl[b, i] of my row
  float corner;     // corner fold
  float best_v;     // cells fold: (value, column) minimum
  int best_j;
  float run_m, run_s;  // soft local: running logsumexp pair, base 2
};

// What one step reads and writes outside the warp's registers: the ring
// slots (RingIO, csrc/ring.cuh); qrow, the staged query at
// sq + kQPad + 1 - lane, so qrow[t] is my next step's sample; bl, erp's
// bl[b, :] in global memory for lane 0 of chunk 0 (else null).
struct StepIO : RingIO {
  const float* qrow;
  const float* bl;
};

// A local cell into the lane's folds: the (value, column) minimum, the
// earliest column on a tie; under soft-min the running logsumexp of
// -val/gamma, rescaled only when its max moves.
template <int W>
__device__ __forceinline__ void fold_cell(Lane<W>& L, float val, int j,
                                          const Params& p) {
  if (val < L.best_v || (val == L.best_v && j < L.best_j)) {
    L.best_v = val;
    L.best_j = j;
  }
  if constexpr (kSoft) {
    const float x = -val * p.k2;
    const float d = x - L.run_m;
    const float e = ex2(-fabsf(d));
    L.run_s = d > 0.f ? fmaf(L.run_s, e, 1.f) : L.run_s + e;
    L.run_m = fmaxf(L.run_m, x);
  }
}

// One step of one chunk: lane l computes row i = t - l of its W columns.
// EDGE: every test of family_cell and the folds is on; a steady block
// (EDGE false) tests nothing.
template <int W, int FAM, bool BAND, bool ABS, bool EDGE>
__device__ __forceinline__ void step(Lane<W>& L, int t, int u, int lane,
                                     int j0, int m, int n, int band,
                                     const StepIO& io, const Params& p) {
  const int i = t - lane;
  const float qv = L.qv;
  L.qv = io.qrow[t];                        // next step's sample
  float next_left = kBig;                   // lane 0's next left neighbour
  if (io.reads && (!EDGE || t + 1 < m)) next_left = io.rd[u];
  float next_bl = 0.f;                      // and, chunk 0 of erp, its bl
  if (FAM == kErp && EDGE && io.bl != nullptr && t + 1 < m)
    next_bl = io.bl[t + 1];
  // the row-only terms
  float tup, dl = 0.f, fd = 0.f;
  if constexpr (FAM == kTwed) {
    tup = dist<ABS>(qv, L.qp) + p.nl;
    dl = dist<ABS>(L.qp, L.x0);             // d(q_i-1, r_j0-1)
    fd = static_cast<float>(i - j0);        // i - j at k = 0
  } else if constexpr (FAM == kErp) {
    tup = dist<ABS>(qv, p.gap);
  } else {
    tup = p.gp;
  }
  float lft = L.left, ul = L.upleft;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = j0 + k;
    const float up = L.prev[k];
    float tl, td;
    if constexpr (FAM == kTwed) {
      tl = L.tl[k];
      const float dc = dist<ABS>(qv, L.rv[k]);
      // (d(q_i, r_j) + d(q_i-1, r_j-1)) + 2 nu |i - j|
      td = add_mul(dc + dl, p.two_nu, fabsf(fd - static_cast<float>(k)));
      dl = L.dd[k];                         // d(q_i-1, r_j) for column j+1
      L.dd[k] = dc;
    } else if constexpr (FAM == kErp) {
      tl = L.tl[k];
      td = dist<ABS>(qv, L.rv[k]);
    } else {
      tl = p.gp;
      td = dist<ABS>(qv, L.rv[k]) - p.mr;
    }
    float up_b = up, ul_b = ul, left_b = lft;
    if (EDGE) {
      if (i == 0) {                         // row -1
        if (FAM == kTwed) {
          up_b = kBig;
          ul_b = j == 0 ? 0.f : kBig;
        } else if (FAM == kErp) {
          up_b = L.xv[k];
          ul_b = L.xv[k] - L.tl[k];
        } else {
          up_b = 0.f;
          ul_b = 0.f;
        }
      }
      if (j == 0) {                         // column -1
        if (FAM == kTwed) {
          left_b = kBig;
          if (i != 0) ul_b = kBig;
        } else if (FAM == kErp) {
          left_b = L.bl;
          if (i != 0) ul_b = L.bl - tup;
        } else {
          left_b = 0.f;
          ul_b = 0.f;
        }
      }
    }
    float val = reduce3(left_b + tl, up_b + tup, ul_b + td, p);
    if constexpr (FAM == kLocal) val = floor0(val, p);
    if (EDGE) {
      if (BAND && abs(i - j) > band) {
        val = kBig;                         // out of band: never folded
      } else if (FAM != kLocal) {
        if (i == m - 1 && j == n - 1) L.corner = val;
      } else if (i >= 0 && i < m && j < n && val < 0.5f * kBig) {
        fold_cell(L, val, j, p);
      }
    } else if (FAM == kLocal) {
      fold_cell(L, val, j, p);
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
  if constexpr (FAM == kTwed) L.qp = qv;
  if constexpr (FAM == kErp) L.bl = next_bl;
  // the per-step barrier of every kernel on the ring (csrc/wavefront.cu:
  // nvcc 12.8 miscompiles the wavefront without it)
  __syncwarp();
}

template <int W, int FAM, bool BAND, bool ABS>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
family_kernel(const float* __restrict__ q, const float* __restrict__ r,
              const float* __restrict__ rx, const float* __restrict__ bl,
              int m, int n, int chunks, int band, int slots, Params p,
              float* __restrict__ cost_out, int* __restrict__ end_out) {
  // [warps][slots][2] mbarriers | query [m + 64] f32 | rings [warps]
  // [slots * 32] f32
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float fold_v[kMaxWarps], fold_m[kMaxWarps], fold_s[kMaxWarps];
  __shared__ int fold_j[kMaxWarps];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ring_rows = slots * kGroup;
  const int padded = m + 2 * kQPad;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* sq = reinterpret_cast<float*>(bars + 2 * warps * slots);
  float* ring_v = sq + padded;

  const size_t row = static_cast<size_t>(blockIdx.x) * m;
  for (int x = threadIdx.x; x < padded; x += blockDim.x) {
    const int i = x - kQPad;
    sq[x] = (i >= 0 && i < m) ? q[row + i] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2 * warps * slots; ++k) mbar_init(bars + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto ring = [&](int link) {
    return Ring{ring_v + link * ring_rows, nullptr, bars + 2 * link * slots};
  };
  RingWalk<false> walk{ring(warp), ring((warp + 1) % warps), slots,
                       (m + kGroup - 1) / kGroup, lane};

  Lane<W> L;
  L.corner = kBig;
  L.best_v = kBig;
  L.best_j = INT_MAX;
  L.run_m = -kBig;                          // finite: no -inf - -inf
  L.run_s = 0.f;
  StepIO io;
  io.qrow = sq + kQPad + 1 - lane;

  for (int c = warp; c < chunks; c += warps) {
    walk.open_chunk(c, chunks, io);
    io.bl = FAM == kErp && c == 0 && lane == 0 ? bl + row : nullptr;
    const int j0 = (c * 32 + lane) * W;
    // chunk 0 holds column 0; a chunk that reaches column n-1 holds the
    // corner and the padding
    const int cj0 = c * 32 * W, cj1 = cj0 + 32 * W - 1;
    const bool edge_chunk = c == 0 || cj1 >= n - 1;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      L.rv[k] = r[j0 + k];
      L.prev[k] = kBig;
      if (FAM == kTwed) {
        const float x = rx[j0 + k];
        if (k == 0) L.x0 = x;
        L.tl[k] = dist<ABS>(L.rv[k], x) + p.nl;
        L.dd[k] = dist<ABS>(0.f, L.rv[k]);  // row -1 of the padded query
      } else if (FAM == kErp) {
        L.xv[k] = rx[j0 + k];
        L.tl[k] = dist<ABS>(L.rv[k], p.gap);
      }
    }
    L.left = kBig;                          // chunk 0: injected at j == 0
    if (walk.first_group(io) && lane == 0) L.left = io.rd[0];
    L.upleft = kBig;
    L.qv = sq[kQPad - lane];
    L.qp = sq[kQPad - lane - 1];
    if (FAM == kErp) L.bl = io.bl != nullptr ? io.bl[0] : 0.f;

    // blocks of 32 steps, opened by the ring step (RingWalk)
    for (int g = 0; 32 * g - 1 < m + 31; ++g) {
      const int t0 = 32 * g - 1;
      if (g > 0) walk.open_block(g, io);
      // rows t0-31 .. t0+31 meet neither row 0 nor row m-1; under a band,
      // every cell of the block is in it
      bool steady = !edge_chunk && g >= 2 && t0 + 31 < m - 1;
      if (BAND)
        steady = steady && t0 + 31 - cj0 <= band && cj1 - (t0 - 31) <= band;
      if (steady) {
#pragma unroll 2
        for (int u = 0; u < kGroup; ++u)
          step<W, FAM, BAND, ABS, false>(L, t0 + u, u, lane, j0, m, n, band,
                                         io, p);
      } else {
        const int u1 = min(kGroup, m + 31 - t0);
        for (int u = g == 0 ? 1 : 0; u < u1; ++u)
          step<W, FAM, BAND, ABS, true>(L, t0 + u, u, lane, j0, m, n, band,
                                        io, p);
      }
    }
    walk.close_chunk();
  }

  // merge the lanes of each warp by shuffles, then the warps through
  // shared memory: the corner's minimum (one lane holds it); local's
  // lexicographic (value, column) minimum and, under soft-min, the
  // running-max rule for the logsumexp pairs
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (FAM != kLocal) {
      L.corner = fminf(L.corner, __shfl_down_sync(kFull, L.corner, off));
      continue;
    }
    const float ov = __shfl_down_sync(kFull, L.best_v, off);
    const int oj = __shfl_down_sync(kFull, L.best_j, off);
    if (ov < L.best_v || (ov == L.best_v && oj < L.best_j)) {
      L.best_v = ov;
      L.best_j = oj;
    }
    if constexpr (kSoft) {
      const float om = __shfl_down_sync(kFull, L.run_m, off);
      const float os = __shfl_down_sync(kFull, L.run_s, off);
      const float mx = fmaxf(L.run_m, om);
      L.run_s = L.run_s * exp2f(L.run_m - mx) + os * exp2f(om - mx);
      L.run_m = mx;
    }
  }
  if (lane == 0) {
    fold_v[warp] = FAM != kLocal ? L.corner : L.best_v;
    fold_j[warp] = L.best_j;
    if (kSoft) {
      fold_m[warp] = L.run_m;
      fold_s[warp] = L.run_s;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float bv = fold_v[0], rm = kSoft ? fold_m[0] : 0.f;
  float rs = kSoft ? fold_s[0] : 0.f;
  int bj = fold_j[0];
  for (int w = 1; w < warps; ++w) {
    if (FAM != kLocal) {
      bv = fminf(bv, fold_v[w]);
      continue;
    }
    if (fold_v[w] < bv || (fold_v[w] == bv && fold_j[w] < bj)) {
      bv = fold_v[w];
      bj = fold_j[w];
    }
    if constexpr (kSoft) {
      const float mx = fmaxf(rm, fold_m[w]);
      rs = rs * exp2f(rm - mx) + fold_s[w] * exp2f(fold_m[w] - mx);
      rm = mx;
    }
  }
  if (FAM != kLocal) {
    const bool blocked = bv >= 0.5f * kBig;
    cost_out[blockIdx.x] = blocked ? INFINITY : bv;
    end_out[blockIdx.x] = blocked ? 0 : n - 1;
  } else {
    cost_out[blockIdx.x] = kSoft ? -p.gl * (rm + log2f(rs)) : bv;
    end_out[blockIdx.x] = bj;
  }
}

// Dynamic shared memory of one CTA; kernels/family.py::family_geometry
// computes the same number.
size_t smem_bytes(int m, int warps, int slots) {
  return 16 * static_cast<size_t>(warps) * slots +
         4 * (static_cast<size_t>(m) + 2 * kQPad) +
         4 * static_cast<size_t>(warps) * slots * kGroup;
}

template <int W, int FAM, bool BAND, bool ABS>
int launch(const float* q, const float* r, const float* rx, const float* bl,
           int batch, int m, int n, int chunks, int band, int warps,
           int slots, const Params& p, float* cost, int* end,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(m, warps, slots);
  auto kernel = family_kernel<W, FAM, BAND, ABS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, 32 * warps, smem, stream>>>(q, r, rx, bl, m, n, chunks,
                                              band, slots, p, cost, end);
  return static_cast<int>(cudaGetLastError());
}

template <int W, int FAM, bool BAND, bool ABS>
int occupancy(int m, int warps, int slots) {
  const size_t smem = smem_bytes(m, warps, slots);
  auto kernel = family_kernel<W, FAM, BAND, ABS>;
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

// What an entry asks of an instantiation: op 0 launches, op 1 returns the
// CTAs resident per SM (or -error).
struct Call {
  int op;
  const float *q, *r, *rx, *bl;
  int batch, m, n, chunks, band, warps, slots;
  Params p;
  float* cost;
  int* end;
  cudaStream_t stream;
};

template <int W, int FAM>
int dispatch_family(const Call& a, int abs_dist) {
  const bool banded = a.band >= 0;
#define REPRO_CASE(BND, ABSD)                                               \
  if (banded == BND && !!abs_dist == ABSD)                                  \
    return a.op == 0                                                        \
               ? launch<W, FAM, BND, ABSD>(a.q, a.r, a.rx, a.bl, a.batch,   \
                                           a.m, a.n, a.chunks, a.band,      \
                                           a.warps, a.slots, a.p, a.cost,   \
                                           a.end, a.stream)                 \
               : occupancy<W, FAM, BND, ABSD>(a.m, a.warps, a.slots);
  REPRO_CASE(false, false)
  REPRO_CASE(false, true)
  REPRO_CASE(true, false)
  REPRO_CASE(true, true)
#undef REPRO_CASE
  return -1;
}

template <int W>
int dispatch(const Call& a, int family, int abs_dist) {
  switch (family) {
    case kTwed: return dispatch_family<W, kTwed>(a, abs_dist);
    case kErp: return dispatch_family<W, kErp>(a, abs_dist);
    case kLocal: return dispatch_family<W, kLocal>(a, abs_dist);
    default: return -1;
  }
}

int entry(const Call& a, int width, int family, int abs_dist) {
  const int bad = a.op == 0 ? static_cast<int>(cudaErrorInvalidValue)
                            : -static_cast<int>(cudaErrorInvalidValue);
  if (a.warps < 1 || a.warps > kMaxWarps || a.slots < 1) return bad;
  int status = -1;
  switch (width) {
    case 2: status = dispatch<2>(a, family, abs_dist); break;
    case 4: status = dispatch<4>(a, family, abs_dist); break;
    case 8: status = dispatch<8>(a, family, abs_dist); break;
    case 14: status = dispatch<14>(a, family, abs_dist); break;
    case 16: status = dispatch<16>(a, family, abs_dist); break;
    case 32: status = dispatch<32>(a, family, abs_dist); break;
    default: break;
  }
  return status == -1 ? bad : status;
}

}  // namespace

extern "C" {

// q: (batch, m) f32; r: (chunks_total * 32 * width,) f32, zero-padded past
// n; rx: twed's r_prev or erp's bt, laid out like r (null for local); bl:
// erp's (batch, m) query prefix (null otherwise); the kernel visits the
// first `chunks` chunks.  band < 0: unbanded.  family: 0 twed, 1 erp,
// 2 local.  warps: warps per CTA (1..8); slots: ring groups of 32 rows per
// link (kernels/family.py::family_geometry).  gamma: the soft-min
// temperature (the hard build reads none).  cost (batch,) f32, end
// (batch,) i32.  Returns cudaGetLastError() (cudaErrorInvalidValue for a
// width, family or geometry with no instantiation).
int REPRO_ENTRY(family_wavefront_launch)(
    const void* q, const void* r, const void* rx, const void* bl, int batch,
    int m, int n, int chunks, int band, int width, int family, int abs_dist,
    int warps, int slots, float nl, float two_nu, float gap,
    float gap_penalty, float match_reward, float gamma, void* cost,
    void* end, void* stream) {
  // the base-2 constants, formed in double and rounded once
  const double g = gamma;
  const Params p{nl, two_nu, gap, gap_penalty, match_reward,
                 static_cast<float>(1.4426950408889634 / g),
                 static_cast<float>(g * 0.6931471805599453)};
  const Call a{0, static_cast<const float*>(q), static_cast<const float*>(r),
               static_cast<const float*>(rx), static_cast<const float*>(bl),
               batch, m, n, chunks, band, warps, slots, p,
               static_cast<float*>(cost), static_cast<int*>(end),
               static_cast<cudaStream_t>(stream)};
  return entry(a, width, family, abs_dist);
}

// CTAs of the instantiation resident per SM at this geometry, or a
// negative CUDA error code.
int REPRO_ENTRY(family_wavefront_occupancy)(int m, int width, int family,
                                            int banded, int abs_dist,
                                            int warps, int slots) {
  const Call a{1, nullptr, nullptr, nullptr, nullptr, 0, m, 0, 0,
               banded ? 0 : -1, warps, slots, Params{}, nullptr, nullptr,
               nullptr};
  return entry(a, width, family, abs_dist);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
