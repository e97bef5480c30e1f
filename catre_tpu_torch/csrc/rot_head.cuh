// Widths and per-object GroupNorm helpers shared by the rotation-head
// kernels: K3, K7 and K8 (rot_head.cu, forward; K7/K8 with several objects per
// block) and K4 (rot_head_bwd.cu, backward).
// Both heads run joint as C = 512 channels ([0:256] head x, [256:512]
// head y) with 64 GroupNorm groups of 8 channels over all P points.
#pragma once

#include "common.cuh"

namespace catre {
namespace rot {

constexpr int CIN = 64;    // point-feature width
constexpr int F = 256;     // per-head width
constexpr int C = 2 * F;   // joint width
constexpr int G = 64;      // joint GroupNorm groups (2 heads x 32)
constexpr int CPG = C / G; // channels per group
constexpr int LDP = CIN + kPad;
constexpr int LDA = C + kPad;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

// gelu(x) = x Phi(x) and its derivative Phi(x) + x phi(x), from one erf
__device__ __forceinline__ void gelu_and_grad(float x, float& g, float& dg) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752440f));
  g = x * cdf;
  dg = cdf + x * 0.39894228040143267794f * expf(-0.5f * x * x);
}

// d gelu / dx alone (the unused gelu value is dead code)
__device__ __forceinline__ float gelu_grad(float x) {
  float g, dg;
  gelu_and_grad(x, g, dg);
  return dg;
}

// Group statistics from the per-channel sums, over n = P * 8 values per group.
__device__ inline void finish_stats(const float* s1, const float* s2, float* mean, float* inv,
                                    int P) {
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float a = 0.0f, b = 0.0f;
    for (int j = 0; j < CPG; ++j) {
      a += s1[g * CPG + j];
      b += s2[g * CPG + j];
    }
    const float n = static_cast<float>(P) * CPG;
    const float m = a / n;
    mean[g] = m;
    inv[g] = rsqrtf(b / n - m * m + kEps);
  }
}

// Column sums of value(row, col, acc) and of its square into s1[ch0 + col]
// and s2[ch0 + col] (value returns 0 for a row to skip).
template <int MI, typename Fn>
__device__ __forceinline__ void add_sums(const Acc<MI>& acc, Fn value, float* red1, float* red2,
                                         float* s1, float* s2, int ch0) {
  acc_col_reduce(acc, AddOp(), value, red1);
  acc_col_reduce(acc, AddOp(), [&](int r, int c, float x) {
    const float y = value(r, c, x);
    return y * y;
  }, red2);
  __syncthreads();
  const int c = threadIdx.x % kTileN;
  if (threadIdx.x < kTileN) s1[ch0 + c] += red1[c] + red1[kTileN + c];
  else s2[ch0 + c] += red2[c] + red2[kTileN + c];
}

}  // namespace rot
}  // namespace catre
