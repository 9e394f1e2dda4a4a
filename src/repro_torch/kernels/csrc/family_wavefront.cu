// The recurrence-family wavefront (K7) for Hopper (sm_90a).
//
// Replaces: repro/kernels/wavefront.py::wavefront_call (pallas_call body
// _generic_kernel) under the family plans: KernelPlan.cell through
// DPSpec.family_cell (:670-681, repro/core/spec.py:333-431), the extra
// operands r_prev / bt / bl (:95-99, :797-831) and the folds CornerFold
// (twed, erp; :304-337), LocalCellsFold (local; :341-385) and
// SoftCellsFold (soft local; :389-442).  Built twice, by two nvcc side by
// side: hard-min with -fmad=false (libfamily_wavefront) and soft-min with
// -DREPRO_SOFT (libsoft_family_wavefront).  One template, instantiated
// over (segment width W, family, band, distance).
//
// What bounds it on an H100: operations.  Every one of the B*M*N cells
// computes the family's three transition costs, its boundary injections
// and a three-way reduction (plus the local restart floor and, for local,
// a fold on every cell); under soft-min the reductions are logsumexps
// (MUFU exponentials and logarithms).  Bytes moved are small: the
// queries, the reference and one extra operand in, two numbers per query
// out.
//
// Design: K1's (csrc/wavefront.cu).  One warp per query; the zero-padded
// reference is cut into chunks of 32*W columns, lane l owns columns
// chunk*32*W + l*W + k and holds their samples, their extra operand
// (twed's r[j-1], erp's gap prefix bt[j]) and the previous row's W cells
// in registers; at step t lane l computes row i = t - l, its left
// neighbour arrives from lane l-1 by __shfl_up_sync, lane 0 reads a
// double-buffered shared-memory strip written by lane 31 in the previous
// chunk, and a __syncwarp ends every step (see csrc/wavefront.cu for the
// miscompile it prevents).  Per-row operands are read each step: q[i],
// twed's q[i-1] (0 at i = 0), erp's bl[b, i].  The boundaries of
// family_cell are injected at i == 0 and j == 0: the carries' edge values
// (the sentinel kBig) are never read there.
//
// Folds.  Corner (twed, erp): the lane that computes (m-1, n-1) keeps it;
// a corner >= kBig/2 (blocked band) gives (+inf, end 0).  Cells (local):
// every cell with 0 <= i < m, j < n and value < kBig/2 enters a per-lane
// lexicographic (value, column) minimum, merged across the warp by
// shuffles; under soft-min a running logsumexp of -D/gamma over the same
// cells rides beside it (starting at the finite -SOFT_BIG, so no
// -inf - -inf).  The j < n guard matters: the layout pads with 0, a
// plausible sample, and a local cell on a pad column can score better
// than every real one.
//
// Exactness (hard build): every operation is the plain version's, in its
// operand order, rounded as it rounds (__fsub_rn / __fmul_rn / __fadd_rn,
// no fused multiply-add; min is exact); twed's |i - j| is an exact int to
// f32 conversion; the constants nu + lam, 2 nu, g, gap_penalty and
// match_reward arrive as f32 rounded once from double, as torch rounds
// the plain version's Python scalars.  Every in-band cell of twed and erp
// is reachable from the origin and every local cell has the 0 boundary,
// so the sentinel never wins a valid cell's min and the kernel equals the
// engine (which uses +inf) bit for bit.  The soft build is held to the
// plain version within 1e-4 (transcendentals, fused multiply-adds).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTwed = 0, kErp = 1, kLocal = 2;
constexpr float kSoftBig = 1e30f;  // SOFT_BIG of repro/core/spec.py
#ifdef REPRO_SOFT
constexpr bool kSoft = true;
constexpr float kBig = kSoftBig;
#else
constexpr bool kSoft = false;
constexpr float kBig = 3.0e38f;    // KERNEL_BIG
#endif

struct Params {
  float nl;      // nu + lam (twed)
  float two_nu;  // 2 nu (twed)
  float gap;     // g (erp)
  float gp;      // gap_penalty (local)
  float mr;      // match_reward (local)
  float gamma;   // soft-min temperature (soft build)
  float inv_gamma;
};

template <bool ABS>
__device__ __forceinline__ float dist(float a, float b) {
  const float d = __fsub_rn(a, b);
  return ABS ? fabsf(d) : __fmul_rn(d, d);
}

__device__ __forceinline__ float reduce3(float a, float b, float c,
                                         const Params& p) {
  const float mn = fminf(fminf(a, b), c);
  if constexpr (!kSoft) {
    return mn;
  } else {
    const float s = expf((mn - a) * p.inv_gamma) +
                    expf((mn - b) * p.inv_gamma) +
                    expf((mn - c) * p.inv_gamma);
    return mn - p.gamma * logf(s);
  }
}

__device__ __forceinline__ float reduce2(float a, float b, const Params& p) {
  const float mn = fminf(a, b);
  if constexpr (!kSoft) {
    return mn;
  } else {
    const float s = expf((mn - a) * p.inv_gamma) +
                    expf((mn - b) * p.inv_gamma);
    return mn - p.gamma * logf(s);
  }
}

// DPSpec.family_cell: transition3, the boundary injections, reduce3 and
// local's restart floor, in the plain version's operand order.
template <int FAM, bool ABS>
__device__ __forceinline__ float family_cell(float qv, float rv, float xv,
                                             float qp, float blv, float left,
                                             float up, float upleft, int i,
                                             int j, const Params& p) {
  const bool row0 = i == 0, col0 = j == 0;
  float t_left, t_up, t_diag, up_b, left_b, upleft_b;
  if constexpr (FAM == kTwed) {            // xv = r[j-1], qp = q[i-1]
    t_left = __fadd_rn(dist<ABS>(rv, xv), p.nl);
    t_up = __fadd_rn(dist<ABS>(qv, qp), p.nl);
    t_diag = __fadd_rn(__fadd_rn(dist<ABS>(qv, rv), dist<ABS>(qp, xv)),
                       __fmul_rn(p.two_nu, static_cast<float>(abs(i - j))));
    up_b = row0 ? kBig : up;
    left_b = col0 ? kBig : left;
    upleft_b = (row0 || col0) ? ((row0 && col0) ? 0.f : kBig) : upleft;
  } else if constexpr (FAM == kErp) {      // xv = bt[j], blv = bl[i]
    t_left = dist<ABS>(rv, p.gap);
    t_up = dist<ABS>(qv, p.gap);
    t_diag = dist<ABS>(qv, rv);
    up_b = row0 ? xv : up;
    left_b = col0 ? blv : left;
    upleft_b = row0 ? __fsub_rn(xv, dist<ABS>(rv, p.gap))
                    : (col0 ? __fsub_rn(blv, dist<ABS>(qv, p.gap)) : upleft);
  } else {                                 // local
    t_left = p.gp;
    t_up = p.gp;
    t_diag = __fsub_rn(dist<ABS>(qv, rv), p.mr);
    up_b = row0 ? 0.f : up;
    left_b = col0 ? 0.f : left;
    upleft_b = (row0 || col0) ? 0.f : upleft;
  }
  float val = reduce3(__fadd_rn(left_b, t_left), __fadd_rn(up_b, t_up),
                      __fadd_rn(upleft_b, t_diag), p);
  if constexpr (FAM == kLocal) val = reduce2(val, 0.f, p);
  return val;
}

template <int W, int FAM, bool BAND, bool ABS>
__global__ void __launch_bounds__(32)
family_kernel(const float* __restrict__ q, const float* __restrict__ r,
              const float* __restrict__ rx, const float* __restrict__ bl,
              int m, int n, int chunks, int band, Params p,
              float* __restrict__ cost_out, int* __restrict__ end_out) {
  extern __shared__ float strip[];            // [2][m]
  const int lane = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * m;
  const float* qb = q + row;
  const float* blb = FAM == kErp ? bl + row : nullptr;

  float prev[W];                              // row i-1 of my W cells
  float corner = kBig;                        // corner fold
  float best_v = kBig;                        // local fold: (value,
  int best_j = INT_MAX;                       //   column) minimum
  float run_m = -kSoftBig, run_s = 0.f;       // soft local logsumexp

  for (int c = 0; c < chunks; ++c) {
    const int j0 = (c * 32 + lane) * W;
    float rv[W], xv[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      rv[k] = r[j0 + k];
      xv[k] = FAM == kLocal ? 0.f : rx[j0 + k];
      prev[k] = kBig;
    }
    const float* rd = strip + (c & 1) * m;
    float* wr = strip + ((c + 1) & 1) * m;

    float left = (lane == 0 && c > 0) ? rd[0] : kBig;
    float upleft = kBig;

    for (int t = 0; t < m + 31; ++t) {
      const int i = t - lane;
      const int ic = min(max(i, 0), m - 1);
      const float qv = qb[ic];
      float qp = 0.f, blv = 0.f;
      if (FAM == kTwed) qp = (i > 0 && i < m) ? qb[i - 1] : 0.f;  // q[-1]=0
      if (FAM == kErp) blv = blb[ic];
      const bool live = i >= 0 && i < m;
      float lft = left, ul = upleft;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int j = j0 + k;
        const float up = prev[k];
        float val = family_cell<FAM, ABS>(qv, rv[k], xv[k], qp, blv, lft, up,
                                          ul, i, j, p);
        if (BAND && abs(i - j) > band) {
          val = kBig;                         // out of band: never folded
        } else if (FAM != kLocal) {
          if (i == m - 1 && j == n - 1) corner = val;
        } else if (live && j < n && val < 0.5f * kBig) {
          if (val < best_v || (val == best_v && j < best_j)) {
            best_v = val;
            best_j = j;
          }
          if constexpr (kSoft) {
            const float x = -val * p.inv_gamma;
            const float mx = fmaxf(run_m, x);
            run_s = run_s * expf(run_m - mx) + expf(x - mx);
            run_m = mx;
          }
        }
        ul = up;
        prev[k] = val;
        lft = val;
      }
      // my last cell is the left neighbour of lane+1's first cell next step
      const float from_left = __shfl_up_sync(kFull, lft, 1);
      if (lane == 31 && live) wr[i] = lft;
      upleft = left;
      if (lane == 0) {
        left = (c > 0 && t + 1 < m) ? rd[t + 1] : kBig;
      } else {
        left = from_left;
      }
      // K1's per-step barrier, kept for the same reason (csrc/wavefront.cu)
      __syncwarp();
    }
    __syncwarp();
  }

  if (FAM != kLocal) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      corner = fminf(corner, __shfl_down_sync(kFull, corner, off));
    if (lane == 0) {
      const bool blocked = corner >= 0.5f * kBig;
      cost_out[blockIdx.x] = blocked ? INFINITY : corner;
      end_out[blockIdx.x] = blocked ? 0 : n - 1;
    }
    return;
  }
  // lexicographic (value, column) merge; the running-max rule for the
  // logsumexp pairs
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, best_v, off);
    const int oj = __shfl_down_sync(kFull, best_j, off);
    if (ov < best_v || (ov == best_v && oj < best_j)) {
      best_v = ov;
      best_j = oj;
    }
    if constexpr (kSoft) {
      const float om = __shfl_down_sync(kFull, run_m, off);
      const float os = __shfl_down_sync(kFull, run_s, off);
      const float mx = fmaxf(run_m, om);
      run_s = run_s * expf(run_m - mx) + os * expf(om - mx);
      run_m = mx;
    }
  }
  if (lane == 0) {
    cost_out[blockIdx.x] =
        kSoft ? -p.gamma * (run_m + logf(run_s)) : best_v;
    end_out[blockIdx.x] = best_j;
  }
}

template <int W, int FAM, bool BAND, bool ABS>
int launch(const float* q, const float* r, const float* rx, const float* bl,
           int batch, int m, int n, int chunks, int band, const Params& p,
           float* cost, int* end, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(m);
  auto kernel = family_kernel<W, FAM, BAND, ABS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, 32, smem, stream>>>(q, r, rx, bl, m, n, chunks, band, p,
                                      cost, end);
  return static_cast<int>(cudaGetLastError());
}

template <int W, int FAM>
int dispatch_family(const float* q, const float* r, const float* rx,
                    const float* bl, int batch, int m, int n, int chunks,
                    int band, int abs_dist, const Params& p, float* cost,
                    int* end, cudaStream_t s) {
  const bool banded = band >= 0;
#define REPRO_CASE(BND, ABSD)                                              \
  if (banded == BND && !!abs_dist == ABSD)                                 \
    return launch<W, FAM, BND, ABSD>(q, r, rx, bl, batch, m, n, chunks,    \
                                     band, p, cost, end, s);
  REPRO_CASE(false, false)
  REPRO_CASE(false, true)
  REPRO_CASE(true, false)
  REPRO_CASE(true, true)
#undef REPRO_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int W>
int dispatch(const float* q, const float* r, const float* rx,
             const float* bl, int batch, int m, int n, int chunks, int band,
             int family, int abs_dist, const Params& p, float* cost,
             int* end, cudaStream_t s) {
  switch (family) {
    case kTwed: return dispatch_family<W, kTwed>(q, r, rx, bl, batch, m, n, chunks, band, abs_dist, p, cost, end, s);
    case kErp: return dispatch_family<W, kErp>(q, r, rx, bl, batch, m, n, chunks, band, abs_dist, p, cost, end, s);
    case kLocal: return dispatch_family<W, kLocal>(q, r, rx, bl, batch, m, n, chunks, band, abs_dist, p, cost, end, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q: (batch, m) f32; r: (chunks_total * 32 * width,) f32, zero-padded past
// n; rx: twed's r_prev or erp's bt, laid out like r (null for local); bl:
// erp's (batch, m) query prefix (null otherwise); the kernel visits the
// first `chunks` chunks.  band < 0: unbanded.  family: 0 twed, 1 erp,
// 2 local.  cost (batch,) f32, end (batch,) i32.  gamma is read by the
// soft build only.  Returns cudaGetLastError() (cudaErrorInvalidValue for
// a width or family with no instantiation).
int family_wavefront_launch(const void* q, const void* r, const void* rx,
                            const void* bl, int batch, int m, int n,
                            int chunks, int band, int width, int family,
                            int abs_dist, float nl, float two_nu, float gap,
                            float gap_penalty, float match_reward,
                            float gamma, void* cost, void* end,
                            void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* rf = static_cast<const float*>(r);
  const float* xf = static_cast<const float*>(rx);
  const float* bf = static_cast<const float*>(bl);
  float* c = static_cast<float*>(cost);
  int* e = static_cast<int*>(end);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{nl, two_nu, gap, gap_penalty, match_reward, gamma,
                 1.0f / gamma};
#define REPRO_WIDTH(WD)                                                     \
  case WD:                                                                  \
    return dispatch<WD>(qf, rf, xf, bf, batch, m, n, chunks, band, family, \
                        abs_dist, p, c, e, s);
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

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
