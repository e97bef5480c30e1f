// What the two `wgmma` builds of the rotation heads share: K3 forward (with
// K7/K8, its instantiations with several objects per block; rot_head.cu) and
// K4 backward (rot_head_bwd.cu), both bf16, both blocks of one head with the
// head's weights resident in shared memory, a producer warpgroup that feeds
// 64-point tiles through a ring, and two consumer warpgroups on alternate tiles.
// Here: the block's geometry, a consumer thread's coordinates, the polynomial
// GELU and its derivative of the epilogues, and the register bookkeeping of
// per-group sums.
#pragma once

#include "rot_head.cuh"
#include "wgmma_tile.cuh"

namespace catre {
namespace rot {
namespace tc {

constexpr int kTile = 64;                        // points per tile: the rows of a wgmma
constexpr int kTileBytes = kTile * CIN * 2;      // 8 KB, contiguous in device memory
constexpr int kConsumerWarps = 8;                // two warpgroups
constexpr int kConsumerThreads = 32 * kConsumerWarps;
constexpr int kBlockThreads = kConsumerThreads + 128;   // + the producer's warpgroup
constexpr int kWptBytes = F * CIN * 2;           // W_pt[h]: one panel of 256 rows
constexpr int kW1Bytes = F * F * 2;              // W1[h]: four panels of 256 rows
constexpr int kConsumerRegs = 240, kProducerRegs = 24;   // 2 x 128 x 240 + 128 x 24 = 64512
constexpr int kConsumerBarrier = 1;

// A consumer thread: warp cw of 8, warpgroup wgi, warp w of the warpgroup,
// lane = 4 g + t (the fragment coordinates of wgmma_tile.cuh).
struct Who {
  int cw, wgi, w, lane, g, t;
  __device__ Who() {
    cw = threadIdx.x / 32;
    wgi = cw / 4;
    w = cw % 4;
    lane = threadIdx.x % 32;
    g = lane / 4;
    t = lane % 4;
  }
};

// erf for the epilogue: erf(x) = sign(x) (1 - 2^(t p(t))), t = min(|x|, 4), p of
// degree 7 fitted to log2(erfc(t)) / t on (0, 4] (erfc(4) = 1.5e-8 is below
// half an ulp of 1). Largest absolute error against erf 1.1e-7 over the whole
// line, the size of erff's own two ulps near 1 and far below the tanh
// stand-in's 2.6e-5; what GELU needs is absolute accuracy, since it multiplies
// 1 + erf by x / 2. Branch-free: 7 FFMA, one ex2 and a handful of others
// against erff's two polynomials and a select, with which K3 took 2.13
// ms at 256 objects x 2048 points on an H100 (700 W) against 1.29 ms with this
// one. tests/test_torch_rot_head.py reads the coefficients from this file.
__device__ constexpr float kErfPoly[8] = {-1.6279101371765137f,    -0.918394923210144f,
                               -0.1485847681760788f,    0.028485344722867012f,
                               -0.0010466595413163304f, -0.0013183593982830644f,
                               0.00039122201269492507f, -3.856721014017239e-05f};

// GELU in its exact-erf form, x / 2 (1 + erf(x / sqrt 2)), on that erf, for N
// values at once: their polynomial chains are written side by side, so that a
// warp has N independent instructions ready at every step.
template <int N>
__device__ __forceinline__ void gelu7(float (&x)[N]) {
  float t[N], p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    t[i] = fminf(fabsf(x[i] * 0.70710678118654752440f), 4.0f);
    p[i] = kErfPoly[7];
  }
#pragma unroll
  for (int k = 6; k >= 0; --k)
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = fmaf(p[i], t[i], kErfPoly[k]);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float e;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(p[i] * t[i]));
    const float half_x = 0.5f * x[i];
    x[i] = fmaf(half_x, copysignf(1.0f - e, x[i]), half_x);
  }
}

// The derivative beside it: GELU'(x) = Phi(x) + x phi(x), Phi = (1 + erf(x /
// sqrt 2)) / 2 on the same polynomial and phi(x) = exp(-x^2 / 2) / sqrt(2 pi)
// by one more ex2. dg = GELU'(x); x becomes GELU(x) = x Phi(x) (dead code
// where the caller drops it). tests/test_torch_rot_head_bwd.py reads the two
// constants from this file.
constexpr float kHalfLog2E = 0.72134752044448170368f;     // log2(e) / 2
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;    // 1 / sqrt(2 pi)

template <int N>
__device__ __forceinline__ void gelu7_grad(float (&x)[N], float (&dg)[N]) {
  float t[N], p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    t[i] = fminf(fabsf(x[i] * 0.70710678118654752440f), 4.0f);
    p[i] = kErfPoly[7];
  }
#pragma unroll
  for (int k = 6; k >= 0; --k)
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = fmaf(p[i], t[i], kErfPoly[k]);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float e, q;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(p[i] * t[i]));
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(q) : "f"(-kHalfLog2E * x[i] * x[i]));
    const float cdf = 0.5f + copysignf(fmaf(-0.5f, e, 0.5f), x[i]);
    dg[i] = fmaf(kInvSqrt2Pi * x[i], q, cdf);
    x[i] *= cdf;
  }
}

constexpr int kJG = 2;   // n-tiles (of 4 values a thread) whose GELUs run side by side

__device__ __forceinline__ void consumers_meet() {
  wg::named_barrier(kConsumerBarrier, kConsumerThreads);
}

// The 64 per-thread sums live in registers and are worked on in halves that a
// run-time `half` picks (the two 128-column halves of a tile share their
// code): dst = src[half ? OFF1 : OFF0 ...], and back.
template <int N, int OFF0, int OFF1>
__device__ __forceinline__ void take_part(float (&dst)[N], const float (&src)[64], int half) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = half ? src[OFF1 + i] : src[OFF0 + i];
}
template <int N, int OFF0, int OFF1>
__device__ __forceinline__ void put_part(const float (&part)[N], float (&dst)[64], int half) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (half) dst[OFF1 + i] = part[i];
    else dst[OFF0 + i] = part[i];
  }
}

// A thread's four values of one n-tile (two rows x two columns) into its group's
// sums of x and x^2: group j of the head is n-tile j; sums[0:32] hold the
// sums, sums[32:64] the sums of squares.
__device__ __forceinline__ void add_group_sums(float& s1, float& s2, float x00, float x01,
                                               float x10, float x11) {
  s1 += (x00 + x01) + (x10 + x11);
  s2 += (x00 * x00 + x01 * x01) + (x10 * x10 + x11 * x11);
}

// GroupNorm statistics of this thread's channel (c = 32 cw + lane, group c / 8)
// from every thread's group sums: across the warp by shuffles, across the
// eight warps in warp order through `red` (8 x 64 floats).
__device__ __forceinline__ void group_stats(float* red, const float (&sums)[64], int P,
                                            const Who& me, float& mean, float& inv) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = sums[i];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (me.lane == i % 32) red[me.cw * 64 + i] = x;
  }
  consumers_meet();
  const int g = (32 * me.cw + me.lane) / CPG;
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int w = 0; w < kConsumerWarps; ++w) {
    s1 += red[w * 64 + g];
    s2 += red[w * 64 + 32 + g];
  }
  const float n = static_cast<float>(P) * CPG;
  mean = s1 / n;
  inv = rsqrtf(s2 / n - mean * mean + kEps);
}

}  // namespace tc
}  // namespace rot
}  // namespace catre
