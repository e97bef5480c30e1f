// Fused rotation heads (both per-axis heads of ConvOutPerRotHead) per object.
//
// Replaces the Pallas kernel catre_tpu/ops/pallas_heads.py::
// fused_conv_per_rot_head (:276) on its group=1 path (body _kernel :132).
// Per object, with the two heads joint as 512 channels ([0:256] head x,
// [256:512] head y) over P = n_pcl + n_kps points:
//   x0 = pf @ W_pt^T + gterm[p < n_pcl ? 0 : 1] + b0        (P, 512), f32
//   a  = GELU(GN64(x0))  rounded to T                       64 groups of 8
//   x1 = per head a[:, h] @ W1_h^T + b1                     (P, 512), f32
//   y  = GELU(GN64(x1))
//   v  = per head sum_p pw_h[p] * y[p, h]                   (512)
//   out = [v_x @ neck_x^T | v_y @ neck_y^T] + bias6          (6)
// GELU is the exact erf form (the flax path, layers.py:122); the Pallas
// kernel's tanh stand-in and one-hot GroupNorm matmuls were TPU workarounds.
// Matmul operands are T (bf16 in production, f32 for checks) with f32
// accumulation; everything else is f32, as in the Pallas kernel.
//
// What bounds it on the card: arithmetic. One object costs 2*(2048*64*512 +
// 2*2048*256*256) = 0.67 GFLOP against 256 KB of bf16 point features. The
// (2048, 512) f32 activation is 4 MB, which fitted the TPU's VMEM but not the
// 227 KB of shared memory a block may use, and GroupNorm needs whole-object
// statistics before it can normalise.
//
// Design: one block per object and three passes over tiles of TM points
// (128 in bf16, 64 in f32), recomputing instead of spilling (a global
// scratch of the layer-1 activation would cost 2 MB per object):
//   (a) layer 0 -> GN0 sums;
//   (b) layer 0 -> GN0 -> GELU -> layer 1 -> GN1 sums;
//   (c) as (b), then GN1 -> GELU -> accumulate pw * y per channel;
// then the (512 -> 6) neck. Layer 0 (K = 64) runs three times and layer 1
// twice: 1.47 GFLOP per object in all. The products are `gemm_tile`
// (common.cuh): mma.sync tensor-core tiles fed from shared memory, weights
// staged by cp.async, accumulators kept in registers; every statistic is a
// fixed-order column reduction of those registers, so the sums are
// deterministic.
#include "common.cuh"

using namespace catre;

namespace {

constexpr int CIN = 64;    // point-feature width
constexpr int F = 256;     // per-head width
constexpr int C = 2 * F;   // joint width
constexpr int G = 64;      // joint GroupNorm groups (2 heads x 32)
constexpr int LDP = CIN + kPad;
constexpr int LDA = C + kPad;
constexpr float kEps = 1e-5f;

struct Params {
  const float* gterm;   // (B, 2, C)
  const float* b0;      // (C)
  const float* gn0s;    // (C)
  const float* gn0b;    // (C)
  const float* b1;      // (C)
  const float* gn1s;    // (C)
  const float* gn1b;    // (C)
  const float* pw;      // (2, P)
  const float* neck;    // (6, F): rows 0..2 head x, 3..5 head y
  const float* bias6;   // (6)
  float* out;           // (B, 6)
  int P;
  int n_pcl;
};

// Shared memory: [red1 | red2 (2 x 128 each) | s1 | s2 | v (C each) |
// mean0 inv0 mean1 inv1 (G each) | weight stage | point-feature tile (TM x LDP) |
// layer-1 input tile (TM x LDA)].
template <typename T>
struct Tiles {
  float* red1;
  float* red2;
  float* s1;     // per-channel sums
  float* s2;     // per-channel sums of squares
  float* v;      // per-channel point-weighted sums
  float* mean0;
  float* inv0;
  float* mean1;
  float* inv1;
  T* stage;
  T* pfs;
  T* as;
  __device__ explicit Tiles(unsigned char* smem) {
    red1 = reinterpret_cast<float*>(smem);
    red2 = red1 + 2 * kTileN;
    s1 = red2 + 2 * kTileN;
    s2 = s1 + C;
    v = s2 + C;
    mean0 = v + C;
    inv0 = mean0 + G;
    mean1 = inv0 + G;
    inv1 = mean1 + G;
    stage = reinterpret_cast<T*>(inv1 + G);
    pfs = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(stage) + kStageBytes<T>);
    as = pfs + kTileM<T> * LDP;
  }
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kTileN + 3 * C + 4 * G) + kStageBytes<T> +
         sizeof(T) * kTileM<T> * (LDP + LDA);
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

// Group statistics from the per-channel sums, over n = P * 8 values per group.
__device__ void finish_stats(const float* s1, const float* s2, float* mean, float* inv, int P) {
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float a = 0.0f, b = 0.0f;
    for (int j = 0; j < C / G; ++j) {
      a += s1[g * (C / G) + j];
      b += s2[g * (C / G) + j];
    }
    const float n = static_cast<float>(P) * (C / G);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rot_head_kernel(const T* pf, const T* w_pt, const T* w1, Params q) {
  constexpr int TM = kTileM<T>, MI = TM / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<T> t(smem);
  const int b = blockIdx.x;
  const int P = q.P;
  const T* pfb = pf + static_cast<size_t>(b) * P * CIN;
  const float* gt = q.gterm + static_cast<size_t>(b) * 2 * C;

  for (int i = threadIdx.x; i < 3 * C; i += kThreads) t.s1[i] = 0.0f;   // s1, s2, v

  // x0 of channel ch at tile row r (point p0 + r)
  auto x0 = [&](int p0, int r, int ch, float acc) {
    return acc + gt[(p0 + r < q.n_pcl ? 0 : C) + ch] + q.b0[ch];
  };

  // ---- pass (a): GN0 statistics of x0
  for (int p0 = 0; p0 < P; p0 += TM) {
    const int rows = min(TM, P - p0);
    load_tile(t.pfs, LDP, pfb + static_cast<size_t>(p0) * CIN, rows, TM, CIN);
    for (int c0 = 0; c0 < C; c0 += kTileN) {
      Acc<MI> acc;
      gemm_tile(acc, t.pfs, LDP, w_pt + static_cast<size_t>(c0) * CIN, CIN, CIN, t.stage);
      add_sums(acc, [&](int r, int c, float a) {
        return r < rows ? x0(p0, r, c0 + c, a) : 0.0f;
      }, t.red1, t.red2, t.s1, t.s2, c0);
    }
  }
  __syncthreads();
  finish_stats(t.s1, t.s2, t.mean0, t.inv0, P);
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) t.s1[i] = 0.0f;   // s1, s2

  // ---- pass (b) (pass == 0): GN1 statistics of x1;
  //      pass (c) (pass == 1): point-weighted sums of y = GELU(GN1(x1))
  for (int pass = 0; pass < 2; ++pass) {
    for (int p0 = 0; p0 < P; p0 += TM) {
      const int rows = min(TM, P - p0);
      load_tile(t.pfs, LDP, pfb + static_cast<size_t>(p0) * CIN, rows, TM, CIN);
      // as = round_T(GELU(GN0(x0))) for the whole tile
      for (int c0 = 0; c0 < C; c0 += kTileN) {
        Acc<MI> acc;
        gemm_tile(acc, t.pfs, LDP, w_pt + static_cast<size_t>(c0) * CIN, CIN, CIN, t.stage);
        acc_for_each(acc, [&](int r, int c, float a) {
          const int ch = c0 + c, g = ch / (C / G);
          const float y = (x0(p0, r, ch, a) - t.mean0[g]) * t.inv0[g] * q.gn0s[ch] + q.gn0b[ch];
          t.as[r * LDA + ch] = from_f32<T>(gelu(y));
        });
      }
      for (int h = 0; h < 2; ++h) {
        const float* pwh = q.pw + static_cast<size_t>(h) * P + p0;
        for (int c0 = 0; c0 < F; c0 += kTileN) {
          const int ch0 = h * F + c0;
          Acc<MI> acc;
          gemm_tile(acc, t.as + h * F, LDA, w1 + static_cast<size_t>(ch0) * F, F, F, t.stage);
          if (pass == 0) {
            add_sums(acc, [&](int r, int c, float a) {
              return r < rows ? a + q.b1[ch0 + c] : 0.0f;
            }, t.red1, t.red2, t.s1, t.s2, ch0);
          } else {
            acc_col_reduce(acc, AddOp(), [&](int r, int c, float a) {
              const int ch = ch0 + c, g = ch / (C / G);
              const float y = (a + q.b1[ch] - t.mean1[g]) * t.inv1[g] * q.gn1s[ch] + q.gn1b[ch];
              return r < rows ? pwh[r] * gelu(y) : 0.0f;
            }, t.red1);
            __syncthreads();
            if (threadIdx.x < kTileN)
              t.v[ch0 + threadIdx.x] += t.red1[threadIdx.x] + t.red1[kTileN + threadIdx.x];
          }
        }
      }
    }
    if (pass == 0) {
      __syncthreads();
      finish_stats(t.s1, t.s2, t.mean1, t.inv1, P);
      __syncthreads();
    }
  }

  // ---- neck: out[j] = sum_c v[head(j), c] * neck[j, c] + bias6[j], one warp per j
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < 6) {
    const int base = warp < 3 ? 0 : F;
    float acc = 0.0f;
    for (int c = lane; c < F; c += 32) acc += t.v[base + c] * q.neck[warp * F + c];
    for (int off = 16; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) q.out[static_cast<size_t>(b) * 6 + warp] = acc + q.bias6[warp];
  }
}

template <typename T>
int run(const void* pf, const void* w_pt, const void* w1, const Params& q, int B, void* stream) {
  return launch(rot_head_kernel<T>, B, smem_bytes<T>(), stream, static_cast<const T*>(pf),
                static_cast<const T*>(w_pt), static_cast<const T*>(w1), q);
}

}  // namespace

// pf (B, P, 64), w_pt (512, 64) and w1 (2, 256, 256) in T = bf16 if `bf16`
// else f32; every other array f32 as listed in Params; out (B, 6) f32.
extern "C" int catre_rot_head(const void* pf, const void* gterm, const void* w_pt, const void* b0,
                              const void* gn0s, const void* gn0b, const void* w1, const void* b1,
                              const void* gn1s, const void* gn1b, const void* pw, const void* neck,
                              const void* bias6, void* out, int B, int P, int n_pcl, int bf16,
                              void* stream) {
  Params q;
  q.gterm = static_cast<const float*>(gterm);
  q.b0 = static_cast<const float*>(b0);
  q.gn0s = static_cast<const float*>(gn0s);
  q.gn0b = static_cast<const float*>(gn0b);
  q.b1 = static_cast<const float*>(b1);
  q.gn1s = static_cast<const float*>(gn1s);
  q.gn1b = static_cast<const float*>(gn1b);
  q.pw = static_cast<const float*>(pw);
  q.neck = static_cast<const float*>(neck);
  q.bias6 = static_cast<const float*>(bias6);
  q.out = static_cast<float*>(out);
  q.P = P;
  q.n_pcl = n_pcl;
  return bf16 ? run<catre::bf16>(pf, w_pt, w1, q, B, stream) : run<float>(pf, w_pt, w1, q, B, stream);
}
