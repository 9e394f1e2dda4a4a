// Batch z-normalizer (paper §5.1) for Hopper (sm_90a).
//
// Replaces: repro/kernels/normalizer.py::normalizer_pallas (body _kernel),
// the per-row z-norm of (G, 8, Lp) VMEM tiles.
//
// What bounds it on an H100: memory.  Each element is read once and
// written once; two adds and a multiply per element for the moments and a
// subtract and a divide to normalize are far below the card's arithmetic
// rate.  The least time is the bytes in plus the bytes out over 3.35 TB/s.
//
// Design: every element is read from device memory once, into registers,
// in 16-byte loads, and normalized from there.  A row is cut into a head
// of up to 3 elements (to the first 16-byte boundary of its address: a
// row starts at b*n*4 bytes, so when n is not a multiple of 4 its start
// is not aligned), a body of float4s and a tail of up to 3 elements; the
// head and tail are scalar loads of a few threads.  Two kernels, chosen on
// the host (kernels/normalizer.py::geometry):
//   * row_kernel<V>, for rows of up to 2,048 samples (the query batch):
//     one warp per row, 4 rows per CTA; lane l holds float4s l, l+32, ...
//     (V of them).  The moments are reduced by shuffles alone.
//   * cluster_kernel<V>, for longer rows (the 100,000-sample reference):
//     a thread-block cluster of up to 8 CTAs of 1,024 threads per row
//     (cudaLaunchKernelEx with a cluster dimension), each CTA holding a
//     contiguous slice of the row's float4s, V per thread.  A CTA reduces
//     its partial moments by shuffles and shared memory, then writes them
//     into slot `rank` of every CTA's shared memory (distributed shared
//     memory, cooperative_groups::cluster_group::map_shared_rank); one
//     cluster.sync() makes them visible, and each CTA sums the slots in
//     rank order (so all CTAs get the same mean and std bit for bit) and
//     normalizes its slice from registers.  No CTA touches another's
//     shared memory after that sync, so none can exit while another still
//     reads it.  Before the remote writes, a split barrier (arrive at
//     entry, wait after the loads) makes sure every CTA of the cluster has
//     started.  V = 0 is a fallback for rows too long for the registers
//     (over 8 x 1,024 x 32 samples): it reads its slice twice.
// mean = s/n, var = sq/n - mean^2 (biased), std = sqrt(max(var, eps)), the
// moment formula of repro/core/normalize.py, in float32.  The summation
// order differs from the plain version, so the two agree to about 1e-5,
// not bit for bit.  When asked (stats != nullptr) the kernel also writes
// each row's (mean, var), the residuals of the analytic backward in
// kernels/normalizer.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerCta = 4;       // row_kernel: warps (rows) per CTA
constexpr int kClusterThreads = 1024;
constexpr int kMaxCluster = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// head: elements before the first 16-byte boundary of the row; body:
// whole float4s after it; tail: what is left
struct Split {
  int head, body, tail;
};

__device__ __forceinline__ Split split_row(const float* row, int n) {
  int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) >> 2);
  if (head > n) head = n;
  const int body = (n - head) >> 2;
  return {head, body, n - head - 4 * body};
}

// the scalar element thread `slot` holds (-1: none): slots 0..2 the head,
// slots 8..10 the tail
__device__ __forceinline__ int extra_index(const Split& sp, int slot, int n) {
  if (slot < sp.head) return slot;
  if (slot >= 8 && slot - 8 < sp.tail) return n - sp.tail + (slot - 8);
  return -1;
}

__device__ __forceinline__ void add4(const float4& v, float& s, float& sq) {
  s += (v.x + v.y) + (v.z + v.w);
  sq += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
}

__device__ __forceinline__ float4 norm4(const float4& v, float mean,
                                        float std) {
  return make_float4((v.x - mean) / std, (v.y - mean) / std,
                     (v.z - mean) / std, (v.w - mean) / std);
}

// vec_store: the output rows share the inputs' 16-byte alignment, so the
// body is stored as float4s too (else as scalars)
__device__ __forceinline__ void store4(float* out_body, int idx,
                                       const float4& v, bool vec_store) {
  if (vec_store) {
    reinterpret_cast<float4*>(out_body)[idx] = v;
  } else {
    float* o = out_body + 4 * idx;
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
}

__device__ __forceinline__ void moments(float s, float sq, int n, float eps,
                                        float& mean, float& var,
                                        float& std) {
  mean = s / n;
  var = sq / n - mean * mean;
  std = sqrtf(fmaxf(var, eps));
}

template <int V>
__global__ void __launch_bounds__(32 * kRowsPerCta)
row_kernel(const float* __restrict__ x, float* __restrict__ y,
           float* __restrict__ row_stats, int rows, int n, float eps,
           bool vec_store) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (b >= rows) return;                    // the whole warp
  const float* row = x + static_cast<size_t>(b) * n;
  float* out = y + static_cast<size_t>(b) * n;
  const Split sp = split_row(row, n);
  const float4* body = reinterpret_cast<const float4*>(row + sp.head);

  float4 v[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int idx = u * 32 + lane;
    v[u] = idx < sp.body ? body[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int ei = extra_index(sp, lane, n);
  const float e = ei >= 0 ? row[ei] : 0.f;
  float s = e, sq = e * e;
#pragma unroll
  for (int u = 0; u < V; ++u) add4(v[u], s, sq);
  s = warp_sum(s);
  sq = warp_sum(sq);
  float mean, var, std;
  moments(s, sq, n, eps, mean, var, std);
  if (row_stats != nullptr && lane == 0) {
    row_stats[2 * b] = mean;
    row_stats[2 * b + 1] = var;
  }
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int idx = u * 32 + lane;
    if (idx < sp.body) store4(out + sp.head, idx, norm4(v[u], mean, std),
                              vec_store);
  }
  if (ei >= 0) out[ei] = (e - mean) / std;
}

template <int V>
__global__ void __launch_bounds__(kClusterThreads)
cluster_kernel(const float* __restrict__ x, float* __restrict__ y,
               float* __restrict__ row_stats, int rows, int n, float eps,
               bool vec_store) {
  __shared__ float parts[kMaxCluster][2];   // slot r: CTA r's (s, sq)
  __shared__ float warp_part[32][2];
  cg::cluster_group cluster = cg::this_cluster();
  // every CTA of the cluster has started by the matching wait below
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / csize;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = x + static_cast<size_t>(b) * n;
  float* out = y + static_cast<size_t>(b) * n;
  const Split sp = split_row(row, n);
  const float4* body = reinterpret_cast<const float4*>(row + sp.head);
  const int per = (sp.body + csize - 1) / csize;
  const int lo = rank * per;
  const int hi = min(lo + per, sp.body);

  constexpr int kV = V > 0 ? V : 1;
  float4 v[kV];
  float s = 0.f, sq = 0.f;
  if (V > 0) {
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const int idx = lo + u * kClusterThreads + tid;
      v[u] = idx < hi ? body[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kV; ++u) add4(v[u], s, sq);
  } else {
    for (int idx = lo + tid; idx < hi; idx += kClusterThreads)
      add4(body[idx], s, sq);
  }
  const int ei = rank == 0 ? extra_index(sp, tid, n) : -1;
  const float e = ei >= 0 ? row[ei] : 0.f;
  s += e;
  sq += e * e;

  s = warp_sum(s);
  sq = warp_sum(sq);
  if (lane == 0) {
    warp_part[warp][0] = s;
    warp_part[warp][1] = sq;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    s = lane < nwarps ? warp_part[lane][0] : 0.f;
    sq = lane < nwarps ? warp_part[lane][1] : 0.f;
    s = warp_sum(s);
    sq = warp_sum(sq);
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (tid < csize) {    // warp 0's lanes hold the CTA's sums: push them
    float* dst = cluster.map_shared_rank(&parts[rank][0], tid);
    dst[0] = s;
    dst[1] = sq;
  }
  cluster.sync();
  float ts = 0.f, tsq = 0.f;
  for (int k = 0; k < csize; ++k) {         // rank order: same in every CTA
    ts += parts[k][0];
    tsq += parts[k][1];
  }
  float mean, var, std;
  moments(ts, tsq, n, eps, mean, var, std);
  if (row_stats != nullptr && rank == 0 && tid == 0) {
    row_stats[2 * b] = mean;
    row_stats[2 * b + 1] = var;
  }
  if (V > 0) {
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const int idx = lo + u * kClusterThreads + tid;
      if (idx < hi) store4(out + sp.head, idx, norm4(v[u], mean, std),
                           vec_store);
    }
  } else {
    for (int idx = lo + tid; idx < hi; idx += kClusterThreads)
      store4(out + sp.head, idx, norm4(body[idx], mean, std), vec_store);
  }
  if (ei >= 0) out[ei] = (e - mean) / std;
}

template <int V>
int launch_rows(const float* x, float* y, float* stats, int rows, int n,
                float eps, bool vec_store, cudaStream_t stream) {
  const int grid = (rows + kRowsPerCta - 1) / kRowsPerCta;
  row_kernel<V><<<grid, 32 * kRowsPerCta, 0, stream>>>(x, y, stats, rows, n,
                                                        eps, vec_store);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_cluster(const float* x, float* y, float* stats, int rows, int n,
                   float eps, bool vec_store, int csize,
                   cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows) * csize, 1, 1);
  config.blockDim = dim3(kClusterThreads, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, cluster_kernel<V>, x, y,
                                             stats, rows, n, eps, vec_store);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: (rows, n) f32, row-major and contiguous; stats: (rows, 2) f32
// (mean, biased var) or null.  cluster = 0: row_kernel with vec float4s a
// lane (1, 2, 4, 8 or 16); cluster = 1, 2, 4 or 8: cluster_kernel with
// that many CTAs a row and vec float4s a thread (0, 1, 2, 4 or 8), from
// kernels/normalizer.py::geometry.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a geometry with no instantiation).
int normalizer_launch(const void* x, void* y, void* stats, int rows, int n,
                      float eps, int cluster, int vec, void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_store =
      ((reinterpret_cast<uintptr_t>(x) - reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  if (cluster == 0) {
    switch (vec) {
      case 1: return launch_rows<1>(xf, yf, sf, rows, n, eps, vec_store, s);
      case 2: return launch_rows<2>(xf, yf, sf, rows, n, eps, vec_store, s);
      case 4: return launch_rows<4>(xf, yf, sf, rows, n, eps, vec_store, s);
      case 8: return launch_rows<8>(xf, yf, sf, rows, n, eps, vec_store, s);
      case 16: return launch_rows<16>(xf, yf, sf, rows, n, eps, vec_store, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_CLUSTER(VV)                                                   \
  case VV:                                                                  \
    return launch_cluster<VV>(xf, yf, sf, rows, n, eps, vec_store, cluster, \
                              s);
  switch (vec) {
    REPRO_CLUSTER(0)
    REPRO_CLUSTER(1)
    REPRO_CLUSTER(2)
    REPRO_CLUSTER(4)
    REPRO_CLUSTER(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_CLUSTER
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
