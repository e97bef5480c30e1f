// Backward of both rotation heads (kernel K4): input and parameter gradients
// of the forward in rot_head.cu (K3), given d_out (B, 6).
//
// Replaces the Pallas kernel catre_tpu/ops/pallas_heads_vjp.py::_bwd_kernel
// (:100), launched by _run_bwd_joint (:211) under fused_rot_head_train
// (:263). Per object, with the two heads joint as C = 512 channels over
// P = n_pcl + n_kps points (y0, y1 are the GroupNorm-normalised values):
//   forward   x0 = pf W_pt^T + gterm[p < n_pcl ? 0 : 1] + b0;  h0 = GN0(x0)
//             a = round_T(GELU(h0));  x2 = a W1_h^T + b1;  h1 = GN1(x2)
//             v = sum_p pw_h[p] GELU(h1)
//   backward  d_v = neck^T d_out (per head);  d_neck = v (x) d_out
//             d_h1 = pw (x) d_v * GELU'(h1);  d_pw = sum_c GELU(h1) d_v
//             GN:  d_x = inv (d_y - mean_g(d_y) - y mean_g(d_y y)),  d_y = d_h s
//             d_W1 = d_x2^T a,  d_a = d_x2 W1,  d_h0 = d_a GELU'(h0)
//             d_W_pt = d_x0^T pf,  d_pf = d_x0 W_pt,  d_gterm = sums of d_x0
// GELU' is Phi(x) + x phi(x) with exact erff/expf; the Pallas kernel's Phi
// polynomial was a TPU stand-in. The W_g / g gradients through gterm and the
// folded neck-bias path stay outside, in autograd (pallas_heads_vjp.py:322-347).
//
// What bounds it on the card: per object 2.0 GFLOP (forward recompute 0.67,
// backward 1.34), about 1 TFLOP per call at B = 512, but measured (PERF.md)
// the bound is device-memory traffic at one resident block per SM: about
// 54 MB per object pass through the scratch below, moved at a fifth of the
// card's bandwidth. GroupNorm needs whole-object statistics four times (two
// forward, two backward), and the (P, 512) f32 activations (4 MB per
// object) do not fit the 227 KB of shared memory.
//
// Design (b) of the two considered: per-object pre-activations kept in a
// global scratch instead of recomputed layer by layer. The wrapper allocates
// X0, X2 (B, P, 512) f32 and A, D2, D0 (B, P, 512) in T: 4 GB f32 plus
// 1.5 GB bf16 at B = 512 P = 2048, which training at that batch can afford.
//   1. rot_head_bwd_object, one block per object, six passes:
//      (1) tiles: x0 = layer 0 (mma) -> X0, GN0 sums;
//      (2) tiles: a = GELU(GN0(X0)) -> A and a shared tile, x2 = layer 1 (mma)
//          -> X2, GN1 sums;
//      (3) each thread owns channels t and t + 256 over all points: v, and
//          the per-channel sums of d_h1 and d_h1 y1, from which the GN1
//          backward group means follow; then a warp per point for d_pw;
//      (4) tiles: d_x2 -> D2 and a shared tile, d_a = d_x2 W1 (mma) written
//          over X2's rows;
//      (5) channel-owned sums of d_h0 = d_a GELU'(h0) and d_h0 y0 (GN0
//          backward means);
//      (6) tiles: d_h0 again, d_x0 -> D0 and a shared tile, d_pf = d_x0 W_pt
//          (mma, W_pt^T zero-padded to 128 rows), d_b0 and d_gterm.
//      Loops over points keep each thread on fixed channels, so the GroupNorm
//      constants stay in registers and the loads are coalesced; the mma
//      results go to X0 / X2 as 8-byte pairs (full 32-byte sectors).
//      Per-object partial gradients (biases, GN affine, d_pw, d_neck) go to
//      scratch; nothing is shared between blocks.
//   2. sum_rows adds the per-object partials over objects in a fixed order.
//   3. gemm_tn (gemm_tn.cuh): d_W1 = D2^T A per head and d_W_pt = D0^T pf,
//      products over K = B * P rows, split into fixed K ranges, one block per (128 x 128
//      output tile, range); the operands are transposed into shared memory
//      as they are loaded, then multiplied by the same mma.sync fragments as
//      gemm_tile. Each block writes its partial; sum_rows adds the ranges in
//      a fixed order. No float atomics anywhere: the result is deterministic.
// T = bf16 rounds a, d_x2 and d_x0 to bf16 as matmul operands (f32
// accumulation); T = float is exact FMA, for tight checks on the card.
#include "gemm_tn.cuh"
#include "rot_head.cuh"

using namespace catre;
using namespace catre::rot;

namespace {

// Pointer slots of catre_rot_head_bwd, in the order of
// catre_tpu_torch/ops/rot_head_train.py::SLOTS.
enum Slot {
  PF, GTERM, DOUT, W_PT, W1, W1T, W_PT_T, B0, GN0S, GN0B, B1, GN1S, GN1B, PW, NECK,
  X0, X2, ACT, D2, D0, POBJ, PPW, PNECK, GPART,
  D_PF, D_GTERM, D_VEC, D_PW, D_NECK, D_W_PT, D_W1,
  kSlots
};

struct Obj {
  const float* gterm;   // (B, 2, C)
  const float* dout;    // (B, 6)
  const float* b0;      // (C)
  const float* gn0s;
  const float* gn0b;
  const float* b1;
  const float* gn1s;
  const float* gn1b;
  const float* pw;      // (2, P)
  const float* neck;    // (6, F)
  float* x0;            // (B, P, C) scratch
  float* x2;            // (B, P, C) scratch: x2, then d_a
  float* pobj;          // (B, 6, C): d_b0, d_gn0s, d_gn0b, d_b1, d_gn1s, d_gn1b
  float* ppw;           // (B, 2, P)
  float* pneck;         // (B, 6, F)
  float* d_pf;          // (B, P, CIN)
  float* d_gterm;       // (B, 2, C)
  int P;
  int n_pcl;
};

// Shared memory: [red1 | red2 (2 x 128 each) | s1 | s2 | dv (C each) |
// mean0 inv0 mean1 inv1 gm1 gm2 (G each) | weight stage |
// point-feature tile (TM x LDP) | 512-wide operand tile (TM x LDA)].
template <typename T>
struct Tiles {
  float* red1;
  float* red2;
  float* s1;
  float* s2;
  float* dv;     // d_v per channel
  float* mean0;
  float* inv0;
  float* mean1;
  float* inv1;
  float* gm1;    // GN backward group means of d_y
  float* gm2;    // and of d_y * y
  T* stage;
  T* pfs;
  T* as;
  __device__ explicit Tiles(unsigned char* smem) {
    red1 = reinterpret_cast<float*>(smem);
    red2 = red1 + 2 * kTileN;
    s1 = red2 + 2 * kTileN;
    s2 = s1 + C;
    dv = s2 + C;
    mean0 = dv + C;
    inv0 = mean0 + G;
    mean1 = inv0 + G;
    inv1 = mean1 + G;
    gm1 = inv1 + G;
    gm2 = gm1 + G;
    stage = reinterpret_cast<T*>(gm2 + G);
    pfs = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(stage) + kStageBytes<T>);
    as = pfs + kTileM<T> * LDP;
  }
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kTileN + 3 * C + 6 * G) + kStageBytes<T> +
         sizeof(T) * kTileM<T> * (LDP + LDA);
}

// GN backward group means from per-channel sums: gm1[g] = sum_c s[c] S1[c] / n,
// gm2[g] = sum_c s[c] S2[c] / n over the group's channels (s1, s2 hold s S1
// and s S2). All threads call it; it synchronises before and after.
__device__ inline void backward_means(const float* s1, const float* s2, float* gm1, float* gm2,
                                      int P) {
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float a = 0.0f, b = 0.0f;
    for (int j = 0; j < CPG; ++j) {
      a += s1[g * CPG + j];
      b += s2[g * CPG + j];
    }
    const float n = static_cast<float>(P) * CPG;
    gm1[g] = a / n;
    gm2[g] = b / n;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rot_head_bwd_object(const T* pf, const T* w_pt, const T* w1, const T* w1t, const T* w_pt_t,
                    T* act, T* d2, T* d0, Obj q) {
  constexpr int TM = kTileM<T>, MI = TM / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<T> t(smem);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int P = q.P;
  const size_t obj = static_cast<size_t>(b) * P;
  const T* pfb = pf + obj * CIN;
  const float* gt = q.gterm + static_cast<size_t>(b) * 2 * C;
  const float* dout = q.dout + static_cast<size_t>(b) * 6;
  float* x0b = q.x0 + obj * C;
  float* x2b = q.x2 + obj * C;
  T* actb = act + obj * C;
  T* d2b = d2 + obj * C;
  T* d0b = d0 + obj * C;
  float* pobj = q.pobj + static_cast<size_t>(b) * 6 * C;

  for (int i = tid; i < 2 * C; i += kThreads) t.s1[i] = 0.0f;   // s1, s2
  for (int c = tid; c < C; c += kThreads) {
    const int h = c / F;
    float a = 0.0f;
    for (int j = 3 * h; j < 3 * h + 3; ++j) a += dout[j] * q.neck[j * F + c % F];
    t.dv[c] = a;
  }

  // ---- (1) x0 -> X0, GN0 sums
  for (int p0 = 0; p0 < P; p0 += TM) {
    const int rows = min(TM, P - p0);
    load_tile(t.pfs, LDP, pfb + static_cast<size_t>(p0) * CIN, rows, TM, CIN);
    for (int c0 = 0; c0 < C; c0 += kTileN) {
      Acc<MI> acc;
      gemm_tile(acc, t.pfs, LDP, w_pt + static_cast<size_t>(c0) * CIN, CIN, CIN, t.stage);
      auto x0 = [&](int r, int c, float a) {
        return r < rows ? a + gt[(p0 + r < q.n_pcl ? 0 : C) + c0 + c] + q.b0[c0 + c] : 0.0f;
      };
      acc_store_rows(acc, x0b + static_cast<size_t>(p0) * C + c0, C, rows, x0);
      add_sums(acc, x0, t.red1, t.red2, t.s1, t.s2, c0);
    }
  }
  __syncthreads();
  finish_stats(t.s1, t.s2, t.mean0, t.inv0, P);
  __syncthreads();
  for (int i = tid; i < 2 * C; i += kThreads) t.s1[i] = 0.0f;

  // ---- (2) a = GELU(GN0(x0)) -> A, x2 = layer 1 -> X2, GN1 sums
  for (int p0 = 0; p0 < P; p0 += TM) {
    const int rows = min(TM, P - p0);
#pragma unroll 4
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ch = tid + k * F, g = ch / CPG;
        T a = from_f32<T>(0.0f);
        if (r < rows) {
          const size_t e = static_cast<size_t>(p0 + r) * C + ch;
          a = from_f32<T>(gelu((x0b[e] - t.mean0[g]) * t.inv0[g] * q.gn0s[ch] + q.gn0b[ch]));
          actb[e] = a;
        }
        t.as[r * LDA + ch] = a;
      }
    }
    for (int h = 0; h < 2; ++h) {
      for (int c0 = 0; c0 < F; c0 += kTileN) {
        const int ch0 = h * F + c0;
        Acc<MI> acc;
        gemm_tile(acc, t.as + h * F, LDA, w1 + static_cast<size_t>(ch0) * F, F, F, t.stage);
        auto x2 = [&](int r, int c, float a) { return r < rows ? a + q.b1[ch0 + c] : 0.0f; };
        acc_store_rows(acc, x2b + static_cast<size_t>(p0) * C + ch0, C, rows, x2);
        add_sums(acc, x2, t.red1, t.red2, t.s1, t.s2, ch0);
      }
    }
  }
  __syncthreads();
  finish_stats(t.s1, t.s2, t.mean1, t.inv1, P);
  __syncthreads();

  // ---- (3) thread tid owns channels tid (head x) and tid + F (head y)
  {
    float v[2] = {0.0f, 0.0f}, sd[2] = {0.0f, 0.0f}, sdy[2] = {0.0f, 0.0f};
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ch = tid + k * F, g = ch / CPG;
        const float y = (x2b[static_cast<size_t>(p) * C + ch] - t.mean1[g]) * t.inv1[g];
        const float h1 = y * q.gn1s[ch] + q.gn1b[ch];
        const float w = q.pw[k * P + p];
        float act, dact;
        gelu_and_grad(h1, act, dact);
        v[k] += w * act;
        const float dh = w * t.dv[ch] * dact;
        sd[k] += dh;
        sdy[k] += dh * y;
      }
    }
    for (int k = 0; k < 2; ++k) {
      const int ch = tid + k * F;
      pobj[4 * C + ch] = sdy[k];   // d_gn1s
      pobj[5 * C + ch] = sd[k];    // d_gn1b
      t.s1[ch] = q.gn1s[ch] * sd[k];
      t.s2[ch] = q.gn1s[ch] * sdy[k];
      for (int j = 0; j < 3; ++j)
        q.pneck[(static_cast<size_t>(b) * 6 + 3 * k + j) * F + tid] = v[k] * dout[3 * k + j];
    }
  }
  backward_means(t.s1, t.s2, t.gm1, t.gm2, P);
  {
    // d_pw[h, p] = sum over the head's channels of GELU(h1) d_v, a warp per
    // point; lane owns channels lane + 32 j, h1 = x2 * scale + shift
    const int warp = tid / 32, lane = tid % 32;
    float scale[C / 32], shift[C / 32], dvl[C / 32];
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int ch = lane + 32 * j, g = ch / CPG;
      scale[j] = t.inv1[g] * q.gn1s[ch];
      shift[j] = q.gn1b[ch] - t.mean1[g] * scale[j];
      dvl[j] = t.dv[ch];
    }
    for (int p = warp; p < P; p += kThreads / 32) {
      float acc[2] = {0.0f, 0.0f};
      const float* row = x2b + static_cast<size_t>(p) * C + lane;
#pragma unroll
      for (int j = 0; j < C / 32; ++j) acc[j / (F / 32)] += gelu(row[32 * j] * scale[j] + shift[j]) * dvl[j];
      for (int off = 16; off > 0; off /= 2) {
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
        acc[1] += __shfl_xor_sync(0xffffffffu, acc[1], off);
      }
      if (lane == 0) {
        q.ppw[static_cast<size_t>(b) * 2 * P + p] = acc[0];
        q.ppw[static_cast<size_t>(b) * 2 * P + P + p] = acc[1];
      }
    }
  }

  // ---- (4) d_x2 -> D2, d_a = d_x2 W1 over X2's rows
  {
    float db1[2] = {0.0f, 0.0f};
    for (int p0 = 0; p0 < P; p0 += TM) {
      const int rows = min(TM, P - p0);
#pragma unroll 4
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int ch = tid + k * F, g = ch / CPG;
          float dx = 0.0f;
          if (r < rows) {
            const int p = p0 + r;
            const float y = (x2b[static_cast<size_t>(p) * C + ch] - t.mean1[g]) * t.inv1[g];
            const float dh = q.pw[k * P + p] * t.dv[ch] * gelu_grad(y * q.gn1s[ch] + q.gn1b[ch]);
            dx = t.inv1[g] * (dh * q.gn1s[ch] - t.gm1[g] - y * t.gm2[g]);
            db1[k] += dx;
          }
          const T dxt = from_f32<T>(dx);
          t.as[r * LDA + ch] = dxt;
          if (r < rows) d2b[static_cast<size_t>(p0 + r) * C + ch] = dxt;
        }
      }
      for (int h = 0; h < 2; ++h) {
        for (int c0 = 0; c0 < F; c0 += kTileN) {
          const int ch0 = h * F + c0;
          Acc<MI> acc;
          gemm_tile(acc, t.as + h * F, LDA, w1t + static_cast<size_t>(ch0) * F, F, F, t.stage);
          acc_store_rows(acc, x2b + static_cast<size_t>(p0) * C + ch0, C, rows,
                         [](int, int, float a) { return a; });
        }
      }
    }
    for (int k = 0; k < 2; ++k) pobj[3 * C + tid + k * F] = db1[k];
  }
  __syncthreads();

  // ---- (5) GN0 backward sums, channel-owned
  {
    float sd[2] = {0.0f, 0.0f}, sdy[2] = {0.0f, 0.0f};
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ch = tid + k * F, g = ch / CPG;
        const size_t e = static_cast<size_t>(p) * C + ch;
        const float y = (x0b[e] - t.mean0[g]) * t.inv0[g];
        const float dh = x2b[e] * gelu_grad(y * q.gn0s[ch] + q.gn0b[ch]);   // d_h0
        sd[k] += dh;
        sdy[k] += dh * y;
      }
    }
    for (int k = 0; k < 2; ++k) {
      const int ch = tid + k * F;
      pobj[1 * C + ch] = sdy[k];   // d_gn0s
      pobj[2 * C + ch] = sd[k];    // d_gn0b
      t.s1[ch] = q.gn0s[ch] * sd[k];
      t.s2[ch] = q.gn0s[ch] * sdy[k];
    }
  }
  backward_means(t.s1, t.s2, t.gm1, t.gm2, P);

  // ---- (6) d_x0 -> D0, d_b0, d_gterm, d_pf = d_x0 W_pt
  {
    float db0[2] = {0.0f, 0.0f}, dg_pcl[2] = {0.0f, 0.0f}, dg_kps[2] = {0.0f, 0.0f};
    for (int p0 = 0; p0 < P; p0 += TM) {
      const int rows = min(TM, P - p0);
#pragma unroll 4
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int ch = tid + k * F, g = ch / CPG;
          float dx = 0.0f;
          if (r < rows) {
            const int p = p0 + r;
            const size_t e = static_cast<size_t>(p) * C + ch;
            const float y = (x0b[e] - t.mean0[g]) * t.inv0[g];
            const float dh = x2b[e] * gelu_grad(y * q.gn0s[ch] + q.gn0b[ch]);   // d_h0
            dx = t.inv0[g] * (dh * q.gn0s[ch] - t.gm1[g] - y * t.gm2[g]);
            db0[k] += dx;
            if (p < q.n_pcl) dg_pcl[k] += dx;
            else dg_kps[k] += dx;
          }
          const T dxt = from_f32<T>(dx);
          t.as[r * LDA + ch] = dxt;
          if (r < rows) d0b[static_cast<size_t>(p0 + r) * C + ch] = dxt;
        }
      }
      Acc<MI> acc;
      gemm_tile(acc, t.as, LDA, w_pt_t, C, C, t.stage);
      acc_for_each(acc, [&](int r, int c, float a) {
        if (r < rows && c < CIN) q.d_pf[(obj + p0 + r) * CIN + c] = a;
      });
    }
    for (int k = 0; k < 2; ++k) {
      const int ch = tid + k * F;
      pobj[ch] = db0[k];
      q.d_gterm[static_cast<size_t>(b) * 2 * C + ch] = dg_pcl[k];
      q.d_gterm[static_cast<size_t>(b) * 2 * C + C + ch] = dg_kps[k];
    }
  }
}

template <typename T>
int run(void* const* ptr, int B, int P, int n_pcl, int splits, void* stream) {
  auto f = [&](Slot s) { return static_cast<float*>(ptr[s]); };
  auto tp = [&](Slot s) { return static_cast<T*>(ptr[s]); };
  Obj q;
  q.gterm = f(GTERM);
  q.dout = f(DOUT);
  q.b0 = f(B0);
  q.gn0s = f(GN0S);
  q.gn0b = f(GN0B);
  q.b1 = f(B1);
  q.gn1s = f(GN1S);
  q.gn1b = f(GN1B);
  q.pw = f(PW);
  q.neck = f(NECK);
  q.x0 = f(X0);
  q.x2 = f(X2);
  q.pobj = f(POBJ);
  q.ppw = f(PPW);
  q.pneck = f(PNECK);
  q.d_pf = f(D_PF);
  q.d_gterm = f(D_GTERM);
  q.P = P;
  q.n_pcl = n_pcl;
  int err = launch(rot_head_bwd_object<T>, B, smem_bytes<T>(), stream,
                   static_cast<const T*>(tp(PF)), static_cast<const T*>(tp(W_PT)),
                   static_cast<const T*>(tp(W1)), static_cast<const T*>(tp(W1T)),
                   static_cast<const T*>(tp(W_PT_T)), tp(ACT), tp(D2), tp(D0), q);
  if (err) return err;
  const int sums[3][2] = {{POBJ, D_VEC}, {PPW, D_PW}, {PNECK, D_NECK}};
  const int widths[3] = {6 * C, 2 * P, 6 * F};
  for (int i = 0; i < 3; ++i) {
    err = launch(sum_rows, (widths[i] + kThreads - 1) / kThreads, 0, stream,
                 static_cast<const float*>(ptr[sums[i][0]]), static_cast<float*>(ptr[sums[i][1]]),
                 B, widths[i]);
    if (err) return err;
  }
  const long long K = static_cast<long long>(B) * P;
  err = product_tn<T>(tp(D2), C, tp(ACT), C, F, 2, F, F, K, splits, f(GPART), f(D_W1), stream);
  if (err) return err;
  return product_tn<T>(tp(D0), C, tp(PF), CIN, 0, 1, C, CIN, K, splits, f(GPART), f(D_W_PT),
                       stream);
}

}  // namespace

// ptr: kSlots device pointers in the order of Slot; pf, w_pt, w1, w1t, w_pt_t,
// act, d2 and d0 hold T = bf16 if `bf16` else float, every other array f32.
extern "C" int catre_rot_head_bwd(void* const* ptr, int B, int P, int n_pcl, int bf16,
                                  int splits, void* stream) {
  return bf16 ? run<catre::bf16>(ptr, B, P, n_pcl, splits, stream)
              : run<float>(ptr, B, P, n_pcl, splits, stream);
}

extern "C" int catre_rot_head_bwd_slots() { return kSlots; }
