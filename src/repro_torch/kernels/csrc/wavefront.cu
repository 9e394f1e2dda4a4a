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
//     boundary strips and its reverse=True sweep (K6).
//   * bf16-K1 (the hard-min half built with -DREPRO_BF16 as
//     libwavefront_bf16): K1/K3/K4 under compute_dtype=bfloat16
//     (CarryChannel.reg_dtype, :132-134), see bf16() below.
// The three libraries are compiled by three nvcc processes side by side.
//
// The hard-min kernel.  What bounds it on an H100: operations.  Every one of the B*M*N cells
// costs a subtract, a multiply (or an abs), two mins and an add, all in a
// chain along the row, and reads nothing from device memory (the query
// sample and the W reference samples sit in registers).  Bytes moved are
// negligible: B*M + N floats in, three numbers per query out.
//
// Design.  One warp per query.  The reference is cut into chunks of
// 32*W columns; lane l owns the W consecutive columns
// chunk*32*W + l*W + k (k < W) and holds their reference samples and the
// previous row's W cell values in registers (the paper's thread
// coarsening).  Within a chunk the warp sweeps the anti-diagonal: at step
// t lane l computes query row i = t - l, so the left neighbour of its
// first cell is lane l-1's last cell of the same row, computed one step
// earlier, which arrives by __shfl_up_sync (the TPU kernel's pltpu.roll).
// Lane 0 reads its left neighbour from the boundary strip that lane 31
// wrote during the previous chunk.
//
// The TPU kernel ran its reference blocks as a sequential grid axis that
// shared ONE VMEM strip.  CUDA blocks run concurrently and in no order, so
// here the chunk loop runs inside the warp, and the strip is a
// double-buffered shared-memory column of length M (the paper's two
// buffers): chunk c reads buffer c&1 and writes buffer (c+1)&1, and a
// __syncwarp between chunks orders lane 31's writes before lane 0's
// reads (a second one ends every step; see there).  All 32 lanes execute
// every step, so every shuffle has a full mask; cells of rows outside
// [0, M) are computed and never used.
//
// Exactness: cells round as the plain version does ((q-r)*(q-r) with
// __fmul_rn, no fused multiply-add, then __fadd_rn), and min is exact, so
// on identical inputs cost, end and start equal the plain version bit for
// bit.  Columns j >= n (the tail of the last chunk) are computed from the
// zero padding of the reference and never folded; they only feed columns
// to their right.  Each lane folds its bottom-row cells with a strict <
// over ascending columns; the warp reduction is lexicographic on
// (value, column), so the earliest column wins a tie.  Band-skip: the
// host passes only the chunks holding a column <= (M-1) + band.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

}  // namespace

#ifndef REPRO_SOFT

#ifdef REPRO_BF16
#include <cuda_bf16.h>
#endif

namespace {

constexpr float kBig = 3.0e38f;   // KERNEL_BIG of repro/core/spec.py
constexpr int kNoWindow = -1;     // NO_WINDOW

// The compute type.  Under -DREPRO_BF16 every operand and every cell
// operation's float32 result is rounded to bf16 (round to nearest even),
// which is what torch's bf16 ops do (compute in float32, round), so the
// cells, the carries and the strip hold bf16 values and equal the plain
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

template <int W, bool WINDOW, bool BAND, bool ABS>
__global__ void __launch_bounds__(32)
wavefront_kernel(const float* __restrict__ q, const float* __restrict__ r,
                 int m, int n, int chunks, int band,
                 float* __restrict__ cost_out, int* __restrict__ end_out,
                 int* __restrict__ start_out) {
  extern __shared__ float strip[];            // [2][m] f32 (+ [2][m] i32)
  int* sstrip = reinterpret_cast<int*>(strip + 2 * m);
  const int lane = threadIdx.x;
  const float* qb = q + static_cast<size_t>(blockIdx.x) * m;

  float prev[W];                              // row i-1 of my W cells
  int sprev[W];
  float best_v = INFINITY;
  int best_j = 0, best_s = kNoWindow;

  for (int c = 0; c < chunks; ++c) {
    const int j0 = (c * 32 + lane) * W;
    float rv[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      rv[k] = bf16(r[j0 + k]);
      prev[k] = kBig;
      sprev[k] = kNoWindow;
    }
    const float* rd = strip + (c & 1) * m;
    float* wr = strip + ((c + 1) & 1) * m;
    const int* srd = sstrip + (c & 1) * m;
    int* swr = sstrip + ((c + 1) & 1) * m;

    // left / upleft of my first cell; lane 0 reads the strip (chunk > 0)
    // or the column -1 edge sentinel
    float left = (lane == 0 && c > 0) ? rd[0] : kBig;
    float upleft = kBig;
    int sleft = (WINDOW && lane == 0 && c > 0) ? srd[0] : kNoWindow;
    int supleft = kNoWindow;

    for (int t = 0; t < m + 31; ++t) {
      const int i = t - lane;
      const float qv = bf16(qb[min(max(i, 0), m - 1)]);
      float lft = left, ul = upleft;
      int slft = sleft, sul = supleft;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int j = j0 + k;
        const float d = bf16(__fsub_rn(qv, rv[k]));
        const float cst = ABS ? fabsf(d) : bf16(__fmul_rn(d, d));
        const float up = prev[k];
        float val;
        int s = 0;
        if (i == 0) {
          val = cst;                          // free start: D[-1, j] = 0
          if (WINDOW) s = j;
        } else {
          val = bf16(__fadd_rn(cst, fminf(fminf(lft, up), ul)));
          if (WINDOW) {
            s = (up < lft) ? sprev[k] : slft;
            s = (ul < fminf(lft, up)) ? sul : s;
          }
        }
        if (BAND && abs(i - j) > band) {
          val = kBig;                         // out of band: never folded
          if (WINDOW) s = kNoWindow;
        } else if (i == m - 1 && j < n && val < best_v) {
          best_v = val;
          best_j = j;
          if (WINDOW) best_s = s;
        }
        ul = up;
        prev[k] = val;
        lft = val;
        if (WINDOW) {
          sul = sprev[k];
          sprev[k] = s;
          slft = s;
        }
      }
      // my last cell is the left neighbour of lane+1's first cell next step
      const float from_left = __shfl_up_sync(kFull, lft, 1);
      int sfrom_left = 0;
      if (WINDOW) sfrom_left = __shfl_up_sync(kFull, slft, 1);
      if (lane == 31 && i >= 0 && i < m) {
        wr[i] = lft;
        if (WINDOW) swr[i] = slft;
      }
      upleft = left;
      supleft = sleft;
      if (lane == 0) {
        const bool from_strip = c > 0 && t + 1 < m;
        left = from_strip ? rd[t + 1] : kBig;
        if (WINDOW) sleft = from_strip ? srd[t + 1] : kNoWindow;
      } else {
        left = from_left;
        if (WINDOW) sleft = sfrom_left;
      }
      // Keep this barrier.  Without it nvcc 12.8 (-O3, sm_90a) split the
      // step loop into a copy for chunk 0 and a copy for later chunks,
      // and the chunk-0 copy stored lane 31's column at strip + i instead
      // of strip + m + i (its SASS store address lacks the m term), so
      // chunk 1 read stale shared memory: wrong, run-dependent results.
      // With the barrier the loop stays one body and every instantiation
      // matches the plain version (chip_smoke.py, phase 3).
      __syncwarp();
    }
    __syncwarp();
  }

  // lexicographic (value, column) reduction: the earliest column wins
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, best_v, off);
    const int oj = __shfl_down_sync(kFull, best_j, off);
    const int os = __shfl_down_sync(kFull, best_s, off);
    if (ov < best_v || (ov == best_v && oj < best_j)) {
      best_v = ov;
      best_j = oj;
      best_s = os;
    }
  }
  if (lane == 0) {
    cost_out[blockIdx.x] = best_v;
    end_out[blockIdx.x] = best_j;
    if (WINDOW) start_out[blockIdx.x] = best_s;
  }
}

template <int W, bool WINDOW, bool BAND, bool ABS>
int launch(const float* q, const float* r, int batch, int m, int n,
           int chunks, int band, float* cost, int* end, int* start,
           cudaStream_t stream) {
  const size_t smem = (WINDOW ? 4 : 2) * sizeof(float) * static_cast<size_t>(m);
  auto kernel = wavefront_kernel<W, WINDOW, BAND, ABS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, 32, smem, stream>>>(q, r, m, n, chunks, band, cost, end,
                                      start);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int dispatch(const float* q, const float* r, int batch, int m, int n,
             int chunks, int band, int window, int abs_dist, float* cost,
             int* end, int* start, cudaStream_t s) {
  const bool banded = band >= 0;
#define REPRO_CASE(WIN, BND, ABSD)                                        \
  if (!!window == WIN && banded == BND && !!abs_dist == ABSD)             \
    return launch<W, WIN, BND, ABSD>(q, r, batch, m, n, chunks, band,     \
                                     cost, end, start, s);
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

// q: (batch, m) f32; r: (chunks_total * 32 * width,) f32, zero-padded past
// n; the kernel visits the first `chunks` chunks.  band < 0: unbanded.
// cost (batch,) f32, end (batch,) i32, start (batch,) i32 (window only).
// Returns cudaGetLastError() (cudaErrorInvalidValue for a width with no
// instantiation).
int wavefront_launch(const void* q, const void* r, int batch, int m, int n,
                     int chunks, int band, int width, int window,
                     int abs_dist, void* cost, void* end, void* start,
                     void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* rf = static_cast<const float*>(r);
  float* c = static_cast<float*>(cost);
  int* e = static_cast<int*>(end);
  int* st = static_cast<int*>(start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 2: return dispatch<2>(qf, rf, batch, m, n, chunks, band, window, abs_dist, c, e, st, s);
    case 4: return dispatch<4>(qf, rf, batch, m, n, chunks, band, window, abs_dist, c, e, st, s);
    case 8: return dispatch<8>(qf, rf, batch, m, n, chunks, band, window, abs_dist, c, e, st, s);
    case 14: return dispatch<14>(qf, rf, batch, m, n, chunks, band, window, abs_dist, c, e, st, s);
    case 16: return dispatch<16>(qf, rf, batch, m, n, chunks, band, window, abs_dist, c, e, st, s);
    case 32: return dispatch<32>(qf, rf, batch, m, n, chunks, band, window, abs_dist, c, e, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
