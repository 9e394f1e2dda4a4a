// The soft-min of the soft wavefronts: K5/K6 (csrc/wavefront.cu built with
// -DREPRO_SOFT) and soft K7 (csrc/family_wavefront.cu built with
// -DREPRO_SOFT) compute their cells with these, from one source.
//
// DPSpec.reduce3 under soft-min is mn - gamma * log(sum exp((mn - x) /
// gamma)) over its three operands, mn their minimum.  The min's own term
// is exp(0) = 1, fixed without a branch, so a cell needs two
// exponentials and one logarithm.  The arguments are pre-scaled by
// k2 = log2(e) / gamma, so that each exponential is one MUFU ex2.approx,
// and the logarithm is one lg2.approx times gl = gamma * ln 2 (both
// constants formed in double on the host and rounded once).
// -DREPRO_EXACT_SOFTMIN swaps in CUDA's full-accuracy exp2f / log2f
// (scripts/wavefront_variants.py builds it to measure the approximation).
// Sentinel SOFT_BIG = 1e30 is finite: ex2 of -SOFT_BIG * k2 is 0, never
// NaN, and three SOFT_BIG operands give SOFT_BIG back.

#pragma once

#ifndef REPRO_EXACT_SOFTMIN
#define REPRO_EXACT_SOFTMIN 0
#endif

namespace {

__device__ __forceinline__ float ex2(float x) {
#if REPRO_EXACT_SOFTMIN
  return exp2f(x);
#else
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#endif
}

__device__ __forceinline__ float lg2(float x) {
#if REPRO_EXACT_SOFTMIN
  return log2f(x);
#else
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#endif
}

// DPSpec.reduce3 under soft-min.  a: the left operand (on the chain);
// b, c: up and upleft, ordered off the chain.  With lo, hi = min,
// max(b, c), the minimum is min(a, lo) and the other two are hi and
// max(a, lo).
__device__ __forceinline__ float smin3(float a, float b, float c, float k2,
                                       float gl) {
  const float lo = fminf(b, c), hi = fmaxf(b, c);
  const float mn = fminf(a, lo), o2 = fmaxf(a, lo);
  const float s = 1.f + ex2((mn - hi) * k2) + ex2((mn - o2) * k2);
  return fmaf(-gl, lg2(s), mn);
}

}  // namespace
