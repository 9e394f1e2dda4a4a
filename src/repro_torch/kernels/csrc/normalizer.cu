// Batch z-normalizer (paper §5.1) for Hopper (sm_90a).
//
// Replaces: repro/kernels/normalizer.py::normalizer_pallas (body _kernel),
// the per-row z-norm of (G, 8, Lp) VMEM tiles.
//
// What bounds it on an H100: memory.  Each element is read once for the
// moments, once more to normalize (the second read mostly hits L2), and
// written once; two adds and a multiply per element are far below the
// card's arithmetic rate.  The least time is the bytes in plus the bytes
// out over 3.35 TB/s.
//
// Design: one CTA per row (the paper's block per query).  A long row
// (the 100,000-sample reference) loops inside its CTA, so no reduction
// crosses CTAs and no second pass is needed.  Each thread accumulates
// sum and sumSq in f32 over a strided slice (coalesced loads), a warp
// shuffle reduces within each warp, shared memory reduces across warps,
// and every thread then writes its slice as (x - mean) / std with
// mean = s/n, var = sq/n - mean^2 (biased), std = sqrt(max(var, eps)),
// the moment formula of repro/core/normalize.py.  The summation order
// differs from the plain version, so the two agree to about 1e-5, not
// bit for bit.  When asked (stats != nullptr) thread 0 also writes the
// row's (mean, var), the residuals of the analytic backward in
// kernels/normalizer.py.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void normalizer_kernel(const float* __restrict__ x,
                                  float* __restrict__ y,
                                  float* __restrict__ row_stats, int n,
                                  float eps) {
  __shared__ float part_s[32];
  __shared__ float part_q[32];
  __shared__ float stats[2];
  const float* row = x + static_cast<size_t>(blockIdx.x) * n;
  float* out = y + static_cast<size_t>(blockIdx.x) * n;

  float s = 0.f, sq = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = row[i];
    s += v;
    sq += v * v;
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) {
    part_s[warp] = s;
    part_q[warp] = sq;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < nwarps ? part_s[lane] : 0.f;
    sq = lane < nwarps ? part_q[lane] : 0.f;
    s = warp_sum(s);
    sq = warp_sum(sq);
    if (lane == 0) {
      const float mean = s / n;
      const float var = sq / n - mean * mean;
      stats[0] = mean;
      stats[1] = sqrtf(fmaxf(var, eps));
      if (row_stats != nullptr) {
        row_stats[2 * blockIdx.x] = mean;
        row_stats[2 * blockIdx.x + 1] = var;
      }
    }
  }
  __syncthreads();
  const float mean = stats[0], std = stats[1];
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = (row[i] - mean) / std;
}

}  // namespace

extern "C" {

// x, y: (rows, n) f32, row-major and contiguous; stats: (rows, 2) f32
// (mean, biased var) or null.  Returns cudaGetLastError().
int normalizer_launch(const void* x, void* y, void* stats, int rows, int n,
                      float eps, void* stream) {
  const int threads = n >= 8192 ? 1024 : 256;
  normalizer_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(stats), n, eps);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
