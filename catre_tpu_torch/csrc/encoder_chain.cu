// PointNet column: three dense layers fused with the per-cloud max, kernel K9.
//
// Replaces the Pallas kernel catre_tpu/ops/pallas_encoder.py::chain3_max
// (:55, body _chain_kernel :25, call :78):
//   h1 = round_T(relu(x  @ W1^T + b1))
//   h2 = round_T(relu(h1 @ W2^T + b2))
//   out[n, c] = max_p (h2 @ W3^T + b3)[p, c], with a ReLU if relu_last
// over one cloud x[n] (P, cin). It serves the STN3d column conv1 -> conv2 ->
// conv3 (3-64-128-1024, relu_last), the STNkd column (64-64-128-1024,
// relu_last) and the main column conv2 -> conv3 -> conv4 (64-128-512-1024).
// Rounding follows _chain_kernel (:35-42), not flax Dense as K1/K2 do: x and
// the weights in T, products accumulated in f32, the f32 bias added in f32,
// one rounding to T after each of the first two ReLUs, the last layer left in
// f32. T is bf16 (production, encoder_chain_wgmma.cuh) or f32 (checks, below).
//
// What bounds it on the card: arithmetic. Per point the main column does
// 2 * (64*128 + 128*512 + 512*1024) = 1.2 MFLOP on 128 input bytes (bf16).
// Unfused, three (points x channels) activations would be written and read.
//
// The bf16 build, the production one, is encoder_chain_wgmma.cuh: `wgmma`,
// the hidden layers chained through registers, the main column on K1's
// kernel and the STN columns on K2's. The f32 build below serves checks: one
// block per cloud walks the cloud in tiles of 64 points with `gemm_tile`
// (common.cuh, plain FMA in f32). The tile's h1 (64 x c1) and h2 (64 x c2)
// stay in shared memory; the third product runs over output chunks of 128
// channels, each folded from its register accumulators into a running max
// per output channel, which starts at -inf. Bias and ReLU of the last layer
// commute with the max and are applied once per cloud. `gemm_tile` wants 128
// output columns and a depth in multiples of 64: the x tile is zero-padded to
// cin_p = ceil64(cin) columns in shared memory (for cin = 3, read with scalar
// loads: no padded copy of x exists in device memory), and the caller pads W1
// to (ceil128(c1), cin_p) with zeros; of layer 1's 128 columns only the first
// c1 are kept.
#include "common.cuh"
#include "encoder_chain_wgmma.cuh"

using namespace catre;

namespace {

struct Widths {
  int cin, cin_p, c1, c2, c3;
};

template <typename T>
size_t smem_bytes(const Widths& w) {
  return sizeof(float) * (2 * kTileN + w.c3) + kStageBytes<T> +
         sizeof(T) * kTileM<T> * ((w.cin_p + kPad) + (w.c1 + kPad) + (w.c2 + kPad));
}

// Shared tile of the cloud's rows [p0, p0 + rows): zero beyond `rows` and
// beyond column cin.
template <typename T>
__device__ __forceinline__ void load_x_tile(T* xs, int ldx, const T* xn, int p0, int rows,
                                            const Widths& w) {
  constexpr int TM = kTileM<T>;
  if (w.cin == w.cin_p) {
    load_tile(xs, ldx, xn + static_cast<size_t>(p0) * w.cin, rows, TM, w.cin);
    return;
  }
  for (int i = threadIdx.x; i < TM * w.cin_p; i += kThreads) {
    const int r = i / w.cin_p, c = i % w.cin_p;
    xs[r * ldx + c] = (r < rows && c < w.cin) ? xn[static_cast<size_t>(p0 + r) * w.cin + c]
                                              : from_f32<T>(0.0f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chain3_max_kernel(const T* x, const T* w1p, const float* b1, const T* w2, const float* b2,
                  const T* w3, const float* b3, float* out, int P, Widths w, int relu_last) {
  constexpr int TM = kTileM<T>, MI = TM / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = w.cin_p + kPad, ld1 = w.c1 + kPad, ld2 = w.c2 + kPad;
  float* red = reinterpret_cast<float*>(smem);
  float* gmax = red + 2 * kTileN;
  T* stage = reinterpret_cast<T*>(gmax + w.c3);
  T* xs = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(stage) + kStageBytes<T>);
  T* h1 = xs + TM * ldx;
  T* h2 = h1 + TM * ld1;

  const int n = blockIdx.x;
  const T* xn = x + static_cast<size_t>(n) * P * w.cin;
  for (int c = threadIdx.x; c < w.c3; c += kThreads) gmax[c] = -INFINITY;

  for (int p0 = 0; p0 < P; p0 += TM) {
    const int rows = min(TM, P - p0);
    load_x_tile(xs, ldx, xn, p0, rows, w);
    // layer 1: h1 = round_T(relu(x @ W1^T + b1)), the first c1 of each 128 columns
    for (int c0 = 0; c0 < w.c1; c0 += kTileN) {
      Acc<MI> acc;
      gemm_tile(acc, xs, ldx, w1p + static_cast<size_t>(c0) * w.cin_p, w.cin_p, w.cin_p, stage);
      acc_for_each(acc, [&](int r, int c, float v) {
        if (c0 + c < w.c1) h1[r * ld1 + c0 + c] = from_f32<T>(fmaxf(v + b1[c0 + c], 0.0f));
      });
    }
    // layer 2: h2 = round_T(relu(h1 @ W2^T + b2))
    for (int c0 = 0; c0 < w.c2; c0 += kTileN) {
      Acc<MI> acc;
      gemm_tile(acc, h1, ld1, w2 + static_cast<size_t>(c0) * w.c1, w.c1, w.c1, stage);
      acc_for_each(acc, [&](int r, int c, float v) {
        h2[r * ld2 + c0 + c] = from_f32<T>(fmaxf(v + b2[c0 + c], 0.0f));
      });
    }
    // layer 3 per output chunk, folded into the running max over the tile's valid rows
    for (int c0 = 0; c0 < w.c3; c0 += kTileN) {
      Acc<MI> acc;
      gemm_tile(acc, h2, ld2, w3 + static_cast<size_t>(c0) * w.c2, w.c2, w.c2, stage);
      acc_col_reduce(acc, MaxOp(), [&](int r, int c, float v) {
        return r < rows ? v : -INFINITY;
      }, red);
      __syncthreads();
      if (threadIdx.x < kTileN) {
        const int c = threadIdx.x;
        gmax[c0 + c] = fmaxf(gmax[c0 + c], fmaxf(red[c], red[kTileN + c]));
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < w.c3; c += kThreads) {
    const float m = gmax[c] + b3[c];
    out[static_cast<size_t>(n) * w.c3 + c] = relu_last ? fmaxf(m, 0.0f) : m;
  }
}

template <typename T>
int run(const void* x, const void* w1p, const void* b1, const void* w2, const void* b2,
        const void* w3, const void* b3, void* out, int n, int p, const Widths& w, int relu_last,
        void* stream) {
  return launch(chain3_max_kernel<T>, n, smem_bytes<T>(w), stream, static_cast<const T*>(x),
                static_cast<const T*>(w1p), static_cast<const float*>(b1),
                static_cast<const T*>(w2), static_cast<const float*>(b2),
                static_cast<const T*>(w3), static_cast<const float*>(b3),
                static_cast<float*>(out), p, w, relu_last);
}

Widths widths(int cin, int c1, int c2, int c3) {
  return Widths{cin, (cin + kSliceK - 1) / kSliceK * kSliceK, c1, c2, c3};
}

}  // namespace

// Shared memory one block needs at these widths (bf16: of the `wgmma` design
// that takes them, 0 if none does), so that the wrapper can refuse widths
// that do not fit before it launches.
extern "C" int catre_chain3_max_smem(int cin, int c1, int c2, int c3, int bf16) {
  return static_cast<int>(bf16 ? chain::smem_bytes(cin, c1, c2, c3)
                               : smem_bytes<float>(widths(cin, c1, c2, c3)));
}

// 128-channel chunks of W3 that a block of the bf16 STN design keeps (the
// wrapper's grid needs them).
extern "C" int catre_chain3_max_chunks() { return chain::kChunks; }

// x (n, p, cin) and the weights in T = bf16 if `bf16` else f32; b1 (c1), b2
// (c2), b3 (c3) f32; out (n, c3) f32. f32: w1 comes as w1p (ceil128(c1),
// ceil64(cin)) zero-padded, w2 (c2, c1), w3 (c3, c2); c1 % 64 == 0, c2 % 128
// == 0, c3 % 128 == 0; `grid` unused. bf16: the widths and layouts of
// encoder_chain_wgmma.cuh::run, `grid` the STN design's persistent blocks.
extern "C" int catre_chain3_max(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* w3, const void* b3, void* out, int n,
                                int p, int cin, int c1, int c2, int c3, int relu_last, int bf16,
                                int grid, void* stream) {
  if (bf16)
    return chain::run(x, w1, b1, w2, b2, w3, b3, out, n, p, cin, c1, c2, c3, relu_last, grid, stream);
  return run<float>(x, w1, b1, w2, b2, w3, b3, out, n, p, widths(cin, c1, c2, c3), relu_last,
                    stream);
}
