// Device code of the PointNet encoder tails in f32: dense (+ReLU +dense)
// fused with the per-cloud max, the f32 builds of the inference kernels K1
// and K2 (encoder_epilogue.cu) and of the training forwards K5 and K6
// (encoder_epilogue_train.cu), which hold the card's arithmetic to tight
// tolerances. The bf16 builds of all four are `wgmma` kernels: K1's body in
// encoder_tail_wgmma.cuh (K6 with kIdx), K2's in encoder_stn_tail_wgmma.cuh
// (K5 with kIdx). The inference and training kernels here differ by one
// template flag: with kIdx they also return, per (cloud, channel), the
// lowest point row that attains the max, which is all the routed backward needs.
//
// Design: one block per cloud walks the cloud in tiles of TM = 64 points. For
// K1/K6 the tile's whole hidden activation h (TM x 512) stays in shared
// memory (133 KB), so GEMM1 is computed once
// per point and not once per output-channel block; GEMM2 then runs over
// output chunks of 128 channels, each folded from its register accumulators
// into a running max per output channel (1024 floats in shared memory). No
// (points x channels) tensor reaches device memory and no atomics are
// needed, since a block owns its cloud. The products are `gemm_tile`
// (common.cuh): mma.sync tensor-core tiles fed from shared memory, weights
// staged by cp.async.
#pragma once

#include <climits>

#include "common.cuh"

namespace catre {
namespace enc {

// Shared memory: [red f32 (2 x 128) | running max f32 (cout) | with kIdx: red
// rows i32 (2 x 128) | running argmax i32 (cout) | weight stage |
// x tile (TM x cin+pad) | h tile (TM x chid+pad)].
template <bool kIdx>
struct Tiles {
  float* red;
  float* gmax;
  int* redi;
  int* gidx;
  float* stage;
  float* xs;
  float* hs;
  __device__ Tiles(unsigned char* smem, int cin, int cout) {
    red = reinterpret_cast<float*>(smem);
    gmax = red + 2 * kTileN;
    if constexpr (kIdx) {
      redi = reinterpret_cast<int*>(gmax + cout);
      gidx = redi + 2 * kTileN;
      stage = reinterpret_cast<float*>(gidx + cout);
    } else {
      redi = gidx = nullptr;
      stage = reinterpret_cast<float*>(gmax + cout);
    }
    xs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(stage) + kStageBytes<float>);
    hs = xs + kTileM<float> * (cin + kPad);
  }
};

template <bool kIdx>
__device__ __forceinline__ void write_max(const MaxOut<kIdx>& o, size_t at, float m, const int* gidx,
                                          int c) {
  o.out[at] = m;
  if constexpr (kIdx) o.idx[at] = gidx[c];
}

template <bool kIdx>
constexpr size_t smem_bytes(int cin, int chid, int cout) {
  return (kIdx ? 2 : 1) * sizeof(float) * (2 * kTileN + cout) + kStageBytes<float> +
         sizeof(float) * kTileM<float> * ((cin + kPad) + (chid ? chid + kPad : 0));
}

// gmax[c] = max(gmax[c], max over the tile's valid rows of acc[r][c] +
// bias[c]), ReLU'd when `relu` (relu commutes with max).
template <int MI>
__device__ __forceinline__ void fold_max(const Acc<MI>& acc, const float* bias, int rows, bool relu,
                                         float* red, float* gmax) {
  acc_col_reduce(acc, MaxOp(), [&](int r, int c, float v) {
    return r < rows ? v + bias[c] : -INFINITY;
  }, red);
  __syncthreads();
  if (threadIdx.x < kTileN) {
    const int c = threadIdx.x;
    const float m = fmaxf(red[c], red[kTileN + c]);
    gmax[c] = fmaxf(gmax[c], relu ? fmaxf(m, 0.0f) : m);
  }
}

// fold_max that also tracks where the max is: (gmax[c], gidx[c]) is the
// running (value, point row) of channel c, the lowest row on equal values.
// ReLU comes before the comparison here, since every non-positive row of a
// channel ties at 0. A thread meets its rows in increasing order and takes a
// later one only if strictly greater; partners in a shuffle and the two warp
// rows are merged preferring the lower row; tiles come in increasing p0 and
// replace the running pair only if strictly greater.
template <int MI>
__device__ __forceinline__ void fold_argmax(const Acc<MI>& acc, const float* bias, int rows,
                                            bool relu, int p0, float* red, int* redi, float* gmax,
                                            int* gidx) {
  const Lane l;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = acc_col(l, j, e);
      float best = -INFINITY;
      int best_r = INT_MAX;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = acc_row<MI>(l, i, 2 * h);
          float v = acc.v[i][j][2 * h + e] + bias[c];
          if (relu) v = fmaxf(v, 0.0f);
          if (r < rows && v > best) {
            best = v;
            best_r = r;
          }
        }
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        const float v = __shfl_xor_sync(0xffffffffu, best, off);
        const int r = __shfl_xor_sync(0xffffffffu, best_r, off);
        if (v > best || (v == best && r < best_r)) {
          best = v;
          best_r = r;
        }
      }
      if (l.g == 0) {
        red[l.wm * kTileN + c] = best;
        redi[l.wm * kTileN + c] = best_r;
      }
    }
  __syncthreads();
  if (threadIdx.x < kTileN) {
    const int c = threadIdx.x;
    float m = red[c];
    int r = redi[c];
    if (red[kTileN + c] > m) {   // warp row 1 holds the higher rows
      m = red[kTileN + c];
      r = redi[kTileN + c];
    }
    if (m > gmax[c]) {
      gmax[c] = m;
      gidx[c] = p0 + r;
    }
  }
}

template <bool kIdx>
__global__ void __launch_bounds__(kThreads)
dense_relu_max_kernel(const float* x, const float* w, const float* b, MaxOut<kIdx> o, int P,
                      int cin, int cout) {
  constexpr int TM = kTileM<float>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<kIdx> t(smem, cin, cout);
  const int ldx = cin + kPad;
  const int n = blockIdx.x;
  for (int c = threadIdx.x; c < cout; c += kThreads) {
    t.gmax[c] = -INFINITY;
    if constexpr (kIdx) t.gidx[c] = 0;
  }
  const float* xn = x + static_cast<size_t>(n) * P * cin;
  for (int p0 = 0; p0 < P; p0 += TM) {
    const int rows = min(TM, P - p0);
    load_tile(t.xs, ldx, xn + static_cast<size_t>(p0) * cin, rows, TM, cin);
    for (int c0 = 0; c0 < cout; c0 += kTileN) {
      Acc<TM / 32> acc;
      gemm_tile(acc, t.xs, ldx, w + static_cast<size_t>(c0) * cin, cin, cin, t.stage);
      if constexpr (kIdx) fold_argmax(acc, b + c0, rows, true, p0, t.red, t.redi, t.gmax + c0, t.gidx + c0);
      else fold_max(acc, b + c0, rows, true, t.red, t.gmax + c0);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cout; c += kThreads)
    write_max(o, static_cast<size_t>(n) * cout + c, t.gmax[c], t.gidx, c);
}

template <bool kIdx>
__global__ void __launch_bounds__(kThreads)
dense_relu_dense_max_kernel(const float* x, const float* w3, const float* b3, const float* w4,
                            const float* b4, MaxOut<kIdx> o, int P, int cin, int chid, int cout) {
  constexpr int TM = kTileM<float>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<kIdx> t(smem, cin, cout);
  const int ldx = cin + kPad, ldh = chid + kPad;
  const int n = blockIdx.x;
  for (int c = threadIdx.x; c < cout; c += kThreads) {
    t.gmax[c] = -INFINITY;
    if constexpr (kIdx) t.gidx[c] = 0;
  }
  const float* xn = x + static_cast<size_t>(n) * P * cin;
  for (int p0 = 0; p0 < P; p0 += TM) {
    const int rows = min(TM, P - p0);
    load_tile(t.xs, ldx, xn + static_cast<size_t>(p0) * cin, rows, TM, cin);
    // GEMM1 once per point: h = relu(x @ W3^T + b3) into shared memory
    for (int c0 = 0; c0 < chid; c0 += kTileN) {
      Acc<TM / 32> acc;
      gemm_tile(acc, t.xs, ldx, w3 + static_cast<size_t>(c0) * cin, cin, cin, t.stage);
      acc_for_each(acc, [&](int r, int c, float v) { t.hs[r * ldh + c0 + c] = fmaxf(v + b3[c0 + c], 0.0f); });
    }
    // GEMM2 per output chunk, folded into the running max
    for (int c0 = 0; c0 < cout; c0 += kTileN) {
      Acc<TM / 32> acc;
      gemm_tile(acc, t.hs, ldh, w4 + static_cast<size_t>(c0) * chid, chid, chid, t.stage);
      if constexpr (kIdx) fold_argmax(acc, b4 + c0, rows, false, p0, t.red, t.redi, t.gmax + c0, t.gidx + c0);
      else fold_max(acc, b4 + c0, rows, false, t.red, t.gmax + c0);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cout; c += kThreads)
    write_max(o, static_cast<size_t>(n) * cout + c, t.gmax[c], t.gidx, c);
}

// The launchers: x (n, p, cin), the weights (out, in) and the biases in f32.
template <bool kIdx>
int run_relu_max(const void* x, const void* w, const void* b, MaxOut<kIdx> o, int n, int p, int cin,
                 int cout, void* stream) {
  return launch(dense_relu_max_kernel<kIdx>, n, smem_bytes<kIdx>(cin, 0, cout), stream,
                static_cast<const float*>(x), static_cast<const float*>(w),
                static_cast<const float*>(b), o, p, cin, cout);
}

template <bool kIdx>
int run_relu_dense_max(const void* x, const void* w3, const void* b3, const void* w4,
                       const void* b4, MaxOut<kIdx> o, int n, int p, int cin, int chid, int cout,
                       void* stream) {
  return launch(dense_relu_dense_max_kernel<kIdx>, n, smem_bytes<kIdx>(cin, chid, cout), stream,
                static_cast<const float*>(x), static_cast<const float*>(w3),
                static_cast<const float*>(b3), static_cast<const float*>(w4),
                static_cast<const float*>(b4), o, p, cin, chid, cout);
}

}  // namespace enc
}  // namespace catre
