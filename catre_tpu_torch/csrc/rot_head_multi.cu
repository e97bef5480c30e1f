// Fused rotation heads, GOBJ objects per block: kernels K7 and K8.
//
// Replaces two Pallas kernels that compute one function:
//   K7 catre_tpu/ops/pallas_heads.py::fused_conv_per_rot_head (:276) with
//      group > 1 (body _kernel_grouped :183, call :358);
//   K8 catre_tpu/ops/pallas_heads_blocked.py::fused_conv_per_rot_head_blocked
//      (:112, body _blocked_kernel :25, call :141).
// On the TPU they differ in how G objects share one grid step (stacked
// GroupNorm statistics and block-diagonal point weights against per-head
// static slices); both were ways around the fixed cost of a grid step. Here
// they are one kernel with two wrappers.
//
// The function is K3's (rot_head.cu), per object over P = n_pcl + n_kps points
// with the two heads joint as 512 channels, except for the point reduction:
//   x0 = pf @ W_pt^T + gterm[p < n_pcl ? 0 : 1] + b0        (P, 512), f32
//   a  = GELU(GN64(x0))  rounded to T
//   x1 = per head a[:, h] @ W1_h^T + b1                     (P, 512), f32
//   y  = GELU(GN64(x1))  rounded to T       <- K3 keeps y and pw in f32
//   v  = per head sum_p round_T(pw_h[p]) * y[p, h]          (512), f32 sum
//   out = [v_x @ neck_x^T | v_y @ neck_y^T] + bias6          (6)
// (pallas_heads.py:243-248 and pallas_heads_blocked.py:64-67 cast both
// operands of the point reduction to the compute dtype). GroupNorm statistics
// are per object; GELU is the exact erf form, as in K3.
//
// What bounds it on the card: arithmetic, as K3 (0.67 GFLOP of model work per
// object against 256 KB of bf16 point features).
//
// Design: K3's three passes over tiles of TM points, in a loop over the
// block's GOBJ objects. What a block that owns several objects buys on this
// card is that the per-channel parameters (b0, b1 and the GroupNorm affines,
// 6 x 512 floats) and the point weights, already rounded to T, (2 x P floats)
// are read into shared memory once per block, where K3's epilogues read them
// from device memory for every element. The per-object sums (s1, s2, v) are
// zeroed per object. The grid is B / GOBJ blocks: with few objects the card
// is not filled (B = 256, GOBJ = 8: 32 blocks on 132 SMs).
#include "rot_head.cuh"

using namespace catre;
using namespace catre::rot;

namespace {

struct Params {
  const float* gterm;   // (B, 2, C)
  const float* chan;    // (6, C): b0, gn0s, gn0b, b1, gn1s, gn1b
  const float* pw;      // (2, P)
  const float* neck;    // (6, F): rows 0..2 head x, 3..5 head y
  const float* bias6;   // (6)
  float* out;           // (B, 6)
  int P;
  int n_pcl;
};

// floats of the point-weight region, kept a multiple of 16 bytes
__host__ __device__ constexpr int pw_floats(int P) { return (2 * P + 3) & ~3; }

// Shared memory: [red1 | red2 (2 x 128 each) | s1 | s2 | v (C each) |
// mean0 inv0 mean1 inv1 (G each) | b0 gn0s gn0b b1 gn1s gn1b (C each) |
// point weights rounded to T (2 x P) | weight stage |
// point-feature tile (TM x LDP) | layer-1 input tile (TM x LDA)].
template <typename T>
struct Tiles {
  float* red1;
  float* red2;
  float* s1;
  float* s2;
  float* v;
  float* mean0;
  float* inv0;
  float* mean1;
  float* inv1;
  float* b0;
  float* gn0s;
  float* gn0b;
  float* b1;
  float* gn1s;
  float* gn1b;
  float* pw;
  T* stage;
  T* pfs;
  T* as;
  __device__ Tiles(unsigned char* smem, int P) {
    red1 = reinterpret_cast<float*>(smem);
    red2 = red1 + 2 * kTileN;
    s1 = red2 + 2 * kTileN;
    s2 = s1 + C;
    v = s2 + C;
    mean0 = v + C;
    inv0 = mean0 + G;
    mean1 = inv0 + G;
    inv1 = mean1 + G;
    b0 = inv1 + G;
    gn0s = b0 + C;
    gn0b = gn0s + C;
    b1 = gn0b + C;
    gn1s = b1 + C;
    gn1b = gn1s + C;
    pw = gn1b + C;
    stage = reinterpret_cast<T*>(pw + pw_floats(P));
    pfs = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(stage) + kStageBytes<T>);
    as = pfs + kTileM<T> * LDP;
  }
};

template <typename T>
size_t smem_bytes(int P) {
  return sizeof(float) * (4 * kTileN + 9 * C + 4 * G + pw_floats(P)) + kStageBytes<T> +
         sizeof(T) * kTileM<T> * (LDP + LDA);
}

template <typename T, int GOBJ>
__global__ void __launch_bounds__(kThreads)
rot_head_multi_kernel(const T* pf, const T* w_pt, const T* w1, Params q) {
  constexpr int TM = kTileM<T>, MI = TM / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int P = q.P;
  const Tiles<T> t(smem, P);

  // once per block: the per-channel parameters and the rounded point weights
  for (int i = threadIdx.x; i < 6 * C; i += kThreads) t.b0[i] = q.chan[i];
  for (int i = threadIdx.x; i < 2 * P; i += kThreads) t.pw[i] = round_to<T>(q.pw[i]);
  __syncthreads();

#pragma unroll 1
  for (int o = 0; o < GOBJ; ++o) {
    const int b = blockIdx.x * GOBJ + o;
    const T* pfb = pf + static_cast<size_t>(b) * P * CIN;
    const float* gt = q.gterm + static_cast<size_t>(b) * 2 * C;

    for (int i = threadIdx.x; i < 3 * C; i += kThreads) t.s1[i] = 0.0f;   // s1, s2, v

    // x0 of channel ch at tile row r (point p0 + r)
    auto x0 = [&](int p0, int r, int ch, float acc) {
      return acc + gt[(p0 + r < q.n_pcl ? 0 : C) + ch] + t.b0[ch];
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
    //      pass (c) (pass == 1): point-weighted sums of y = round_T(GELU(GN1(x1)))
    for (int pass = 0; pass < 2; ++pass) {
      for (int p0 = 0; p0 < P; p0 += TM) {
        const int rows = min(TM, P - p0);
        load_tile(t.pfs, LDP, pfb + static_cast<size_t>(p0) * CIN, rows, TM, CIN);
        // as = round_T(GELU(GN0(x0))) for the whole tile
        for (int c0 = 0; c0 < C; c0 += kTileN) {
          Acc<MI> acc;
          gemm_tile(acc, t.pfs, LDP, w_pt + static_cast<size_t>(c0) * CIN, CIN, CIN, t.stage);
          acc_for_each(acc, [&](int r, int c, float a) {
            const int ch = c0 + c, g = ch / CPG;
            const float y = (x0(p0, r, ch, a) - t.mean0[g]) * t.inv0[g] * t.gn0s[ch] + t.gn0b[ch];
            t.as[r * LDA + ch] = from_f32<T>(gelu(y));
          });
        }
        for (int h = 0; h < 2; ++h) {
          const float* pwh = t.pw + h * P + p0;
          for (int c0 = 0; c0 < F; c0 += kTileN) {
            const int ch0 = h * F + c0;
            Acc<MI> acc;
            gemm_tile(acc, t.as + h * F, LDA, w1 + static_cast<size_t>(ch0) * F, F, F, t.stage);
            if (pass == 0) {
              add_sums(acc, [&](int r, int c, float a) {
                return r < rows ? a + t.b1[ch0 + c] : 0.0f;
              }, t.red1, t.red2, t.s1, t.s2, ch0);
            } else {
              acc_col_reduce(acc, AddOp(), [&](int r, int c, float a) {
                const int ch = ch0 + c, g = ch / CPG;
                const float y = (a + t.b1[ch] - t.mean1[g]) * t.inv1[g] * t.gn1s[ch] + t.gn1b[ch];
                return r < rows ? pwh[r] * round_to<T>(gelu(y)) : 0.0f;
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
    __syncthreads();   // v is read before the next object zeroes it
  }
}

template <typename T, int GOBJ>
int run(const void* pf, const void* w_pt, const void* w1, const Params& q, int B, void* stream) {
  return launch(rot_head_multi_kernel<T, GOBJ>, B / GOBJ, smem_bytes<T>(q.P), stream,
                static_cast<const T*>(pf), static_cast<const T*>(w_pt), static_cast<const T*>(w1),
                q);
}

template <typename T>
int run_group(const void* pf, const void* w_pt, const void* w1, const Params& q, int B, int group,
              void* stream) {
  switch (group) {
    case 2: return run<T, 2>(pf, w_pt, w1, q, B, stream);
    case 4: return run<T, 4>(pf, w_pt, w1, q, B, stream);
    case 8: return run<T, 8>(pf, w_pt, w1, q, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory one block needs for P points, so that the wrapper can refuse
// a P that does not fit before it launches.
extern "C" int catre_rot_head_multi_smem(int P, int bf16) {
  return static_cast<int>(bf16 ? smem_bytes<catre::bf16>(P) : smem_bytes<float>(P));
}

// pf (B, P, 64), w_pt (512, 64) and w1 (2, 256, 256) in T = bf16 if `bf16`
// else f32; chan (6, 512) f32 = [b0, gn0s, gn0b, b1, gn1s, gn1b]; every other
// array f32 as listed in Params; out (B, 6) f32. group is 2, 4 or 8 and
// divides B.
extern "C" int catre_rot_head_multi(const void* pf, const void* gterm, const void* w_pt,
                                    const void* chan, const void* w1, const void* pw,
                                    const void* neck, const void* bias6, void* out, int B, int P,
                                    int n_pcl, int group, int bf16, void* stream) {
  if (B % group) return static_cast<int>(cudaErrorInvalidValue);
  Params q;
  q.gterm = static_cast<const float*>(gterm);
  q.chan = static_cast<const float*>(chan);
  q.pw = static_cast<const float*>(pw);
  q.neck = static_cast<const float*>(neck);
  q.bias6 = static_cast<const float*>(bias6);
  q.out = static_cast<float*>(out);
  q.P = P;
  q.n_pcl = n_pcl;
  return bf16 ? run_group<catre::bf16>(pf, w_pt, w1, q, B, group, stream)
              : run_group<float>(pf, w_pt, w1, q, B, group, stream);
}
