// PointNet encoder tails: dense (+ReLU +dense) fused with the per-cloud max.
//
// Replaces the Pallas kernels of catre_tpu/ops/pallas_encoder_epilogue.py:
//   K1 fused_dense_relu_dense_max (:98, body _kernel_2 :51)
//        out[n, c] = max_p ( relu(x[n, p] @ W3^T + b3) @ W4^T + b4 )[c]
//        the main conv3 -> conv4 -> max tail, x (2B, 1024, 128), 128->512->1024;
//   K2 fused_dense_relu_max (:89, body _kernel_1 :41)
//        out[n, c] = max_p relu(x[n, p] @ W^T + b)[c]
//        the STN3d / STNkd conv3 tails, 128 -> 1024.
// Rounding follows flax Dense(dtype=T): each product is accumulated in f32
// and rounded to T, the T bias is added and the sum rounded to T, then ReLU;
// the max is returned in f32. T is bf16 (production) or f32 (checks).
//
// What bounds it on the card: arithmetic. Per point K1 does 2*(128*512 +
// 512*1024) = 1.18 MFLOP on 256 input bytes (bf16), K2 262 KFLOP, far above
// the H100's ~295 FLOP/byte ridge. Unfused, the (2B*1024, 1024) conv4
// activation would be written and read back: 16 GB in bf16 at B = 4096.
//
// Design: one block per cloud walks the cloud in tiles of TM points (128 in
// bf16, 64 in f32). For K1 the tile's whole hidden activation h (TM x 512)
// stays in shared memory (133 KB in either type), so GEMM1 is computed once
// per point and not once per output-channel block; GEMM2 then runs over
// output chunks of 128 channels, each folded from its register accumulators
// into a running max per output channel (1024 floats in shared memory). No
// (points x channels) tensor reaches device memory and no atomics are
// needed, since a block owns its cloud. The products are `gemm_tile`
// (common.cuh): mma.sync tensor-core tiles fed from shared memory, weights
// staged by cp.async.
#include "common.cuh"

using namespace catre;

namespace {

// Shared memory: [red f32 (2 x 128) | running max f32 (cout) | weight stage |
// x tile (TM x cin+pad) | h tile (TM x chid+pad)].
template <typename T>
struct Tiles {
  float* red;
  float* gmax;
  T* stage;
  T* xs;
  T* hs;
  __device__ Tiles(unsigned char* smem, int cin, int cout) {
    red = reinterpret_cast<float*>(smem);
    gmax = red + 2 * kTileN;
    stage = reinterpret_cast<T*>(gmax + cout);
    xs = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(stage) + kStageBytes<T>);
    hs = xs + kTileM<T> * (cin + kPad);
  }
};

template <typename T>
constexpr size_t smem_bytes(int cin, int chid, int cout) {
  return sizeof(float) * (2 * kTileN + cout) + kStageBytes<T> +
         sizeof(T) * kTileM<T> * ((cin + kPad) + (chid ? chid + kPad : 0));
}

// gmax[c] = max(gmax[c], max over the tile's valid rows of
// round(round(acc[r][c]) + bias[c])), ReLU'd when `relu` (relu commutes with max).
template <typename T, int MI>
__device__ __forceinline__ void fold_max(const Acc<MI>& acc, const float* bias, int rows, bool relu,
                                         float* red, float* gmax) {
  acc_col_reduce(acc, MaxOp(), [&](int r, int c, float v) {
    return r < rows ? round_to<T>(round_to<T>(v) + bias[c]) : -INFINITY;
  }, red);
  __syncthreads();
  if (threadIdx.x < kTileN) {
    const int c = threadIdx.x;
    const float m = fmaxf(red[c], red[kTileN + c]);
    gmax[c] = fmaxf(gmax[c], relu ? fmaxf(m, 0.0f) : m);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_relu_max_kernel(const T* x, const T* w, const float* b, float* out, int P, int cin, int cout) {
  constexpr int TM = kTileM<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<T> t(smem, cin, cout);
  const int ldx = cin + kPad;
  const int n = blockIdx.x;
  for (int c = threadIdx.x; c < cout; c += kThreads) t.gmax[c] = -INFINITY;
  const T* xn = x + static_cast<size_t>(n) * P * cin;
  for (int p0 = 0; p0 < P; p0 += TM) {
    const int rows = min(TM, P - p0);
    load_tile(t.xs, ldx, xn + static_cast<size_t>(p0) * cin, rows, TM, cin);
    for (int c0 = 0; c0 < cout; c0 += kTileN) {
      Acc<TM / 32> acc;
      gemm_tile(acc, t.xs, ldx, w + static_cast<size_t>(c0) * cin, cin, cin, t.stage);
      fold_max<T>(acc, b + c0, rows, true, t.red, t.gmax + c0);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cout; c += kThreads) out[static_cast<size_t>(n) * cout + c] = t.gmax[c];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_relu_dense_max_kernel(const T* x, const T* w3, const float* b3, const T* w4, const float* b4,
                            float* out, int P, int cin, int chid, int cout) {
  constexpr int TM = kTileM<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<T> t(smem, cin, cout);
  const int ldx = cin + kPad, ldh = chid + kPad;
  const int n = blockIdx.x;
  for (int c = threadIdx.x; c < cout; c += kThreads) t.gmax[c] = -INFINITY;
  const T* xn = x + static_cast<size_t>(n) * P * cin;
  for (int p0 = 0; p0 < P; p0 += TM) {
    const int rows = min(TM, P - p0);
    load_tile(t.xs, ldx, xn + static_cast<size_t>(p0) * cin, rows, TM, cin);
    // GEMM1 once per point: h = relu(round(round(x @ W3^T) + b3)) into shared memory
    for (int c0 = 0; c0 < chid; c0 += kTileN) {
      Acc<TM / 32> acc;
      gemm_tile(acc, t.xs, ldx, w3 + static_cast<size_t>(c0) * cin, cin, cin, t.stage);
      acc_for_each(acc, [&](int r, int c, float v) {
        const float h = round_to<T>(round_to<T>(v) + b3[c0 + c]);
        t.hs[r * ldh + c0 + c] = from_f32<T>(fmaxf(h, 0.0f));
      });
    }
    // GEMM2 per output chunk, folded into the running max
    for (int c0 = 0; c0 < cout; c0 += kTileN) {
      Acc<TM / 32> acc;
      gemm_tile(acc, t.hs, ldh, w4 + static_cast<size_t>(c0) * chid, chid, chid, t.stage);
      fold_max<T>(acc, b4 + c0, rows, false, t.red, t.gmax + c0);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cout; c += kThreads) out[static_cast<size_t>(n) * cout + c] = t.gmax[c];
}

template <typename T>
int run_relu_max(const void* x, const void* w, const void* b, void* out, int n, int p, int cin,
                 int cout, void* stream) {
  return launch(dense_relu_max_kernel<T>, n, smem_bytes<T>(cin, 0, cout), stream,
                static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(b),
                static_cast<float*>(out), p, cin, cout);
}

template <typename T>
int run_relu_dense_max(const void* x, const void* w3, const void* b3, const void* w4,
                       const void* b4, void* out, int n, int p, int cin, int chid, int cout,
                       void* stream) {
  return launch(dense_relu_dense_max_kernel<T>, n, smem_bytes<T>(cin, chid, cout), stream,
                static_cast<const T*>(x), static_cast<const T*>(w3), static_cast<const float*>(b3),
                static_cast<const T*>(w4), static_cast<const float*>(b4),
                static_cast<float*>(out), p, cin, chid, cout);
}

}  // namespace

// x (n, p, cin) and w (cout, cin) in T = bf16 if `bf16` else f32; b (cout) f32,
// already rounded to T; out (n, cout) f32. cin % 64 == 0, cout % 128 == 0.
extern "C" int catre_dense_relu_max(const void* x, const void* w, const void* b, void* out, int n,
                                    int p, int cin, int cout, int bf16, void* stream) {
  return bf16 ? run_relu_max<catre::bf16>(x, w, b, out, n, p, cin, cout, stream)
              : run_relu_max<float>(x, w, b, out, n, p, cin, cout, stream);
}

// x (n, p, cin), w3 (chid, cin), w4 (cout, chid) in T; b3, b4 f32 rounded to
// T; out (n, cout) f32. cin % 64 == 0, chid and cout % 128 == 0.
extern "C" int catre_dense_relu_dense_max(const void* x, const void* w3, const void* b3,
                                          const void* w4, const void* b4, void* out, int n, int p,
                                          int cin, int chid, int cout, int bf16, void* stream) {
  return bf16 ? run_relu_dense_max<catre::bf16>(x, w3, b3, w4, b4, out, n, p, cin, chid, cout,
                                                stream)
              : run_relu_dense_max<float>(x, w3, b3, w4, b4, out, n, p, cin, chid, cout, stream);
}
