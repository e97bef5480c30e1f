// K1's bf16 build for Hopper: the main encoder tail
//   out[n, c] = max_p round(round(h[n, p] . W4[c]) + b4[c]),
//   h = relu(round(round(x[n, p] W3^T) + b3)),
// x (N, P, cin) bf16, W3 (chid, cin), W4 (cout, chid) bf16, biases f32 already
// rounded to bf16, out (N, cout) f32. It replaces the Pallas kernel
// catre_tpu/ops/pallas_encoder_epilogue.py::fused_dense_relu_dense_max (:98,
// body _kernel_2 :51). With kIdx it is also the bf16 K6 forward, which
// replaces catre_tpu/ops/pallas_encoder_epilogue_vjp.py::_fwd_kernel_2 (:107,
// under dense_relu_dense_max_t :294): the same out and idx[n, c], the lowest
// point row whose rounded value equals out[n, c]. The f32 builds stay on
// `encoder_epilogue.cuh`.
//
// What bounds it on the card: operations. 1.21 GFLOP per cloud of 1024 points
// on 256 KB of input; the weights (1.1 MB) are re-read from L2 once per tile.
//
// The design:
//   - one block per cloud walks the cloud in tiles of 128 points. Two consumer
//     warpgroups own 64 rows of a tile each; one producer thread (its
//     warpgroup gives its registers to the consumers by `setmaxnreg`) streams
//     everything a tile needs through one ring of 16 KB stages by 1-D bulk
//     copies and mbarriers: the x rows of warpgroup 0, those of warpgroup 1,
//     then W3 and W4 as 128-row x 64-column swizzled panels;
//   - the wrapper repacks W3 and W4 into that stage order in device memory
//     (`ops/encoder_epilogue.py::pack_panels`), so each stage is one
//     contiguous 16 KB copy that lands as `wgmma` reads it;
//   - GEMM1 once per point: `wgmma.m64n128k16`, A from registers (ldmatrix of
//     the warpgroup's x rows), B from the ring. Its epilogue (round, + b3,
//     round, ReLU) writes bf16 by `stmatrix` into the warpgroup's own 64 rows of
//     an h tile (128 x chid) kept in shared memory as swizzled K-major panels:
//     16 bytes a row and instruction, no bank conflict;
//   - GEMM2 per 128-column output chunk: `wgmma` with A (h) and B (W4 panels)
//     both in shared memory. No warpgroup reads rows the other wrote, so the
//     only wait between the two products is a 128-thread named barrier;
//   - the max on the bare accumulator: rounding to nearest even and adding a
//     constant are both monotone non-decreasing, so max_p round(round(a_p) +
//     b) = round(round(max_p a_p) + b) exactly. After each chunk a thread
//     takes the max of its two rows per column, the eight row lanes reduce and
//     scatter the 32 columns in 28 shuffles (4 each), and the lane folds them
//     into a per-block table of running maxima by an atomic max on the
//     order-preserving integer image of the float: exact and commutative, so
//     the result does not depend on arrival order. Rows past P enter as -inf.
//     At the end of the cloud the consumers meet once, and each channel is
//     rounded, biased and rounded once;
//   - a stage goes back to the producer only after the products that read it
//     (or the registers loaded from it) have completed; GEMM2 keeps one group
//     of products in flight while it gives back the stage before.
// kIdx (the K6 forward) changes only the fold after each GEMM2 chunk and the
// final write; the products are the same code, so out is K1's value. The max
// on the bare accumulator cannot give the argmax: rows whose accumulators
// differ may tie after the two roundings, and the largest accumulator's row
// need not be the lowest of them. So every element is rounded (two at a time,
// in bf16x2) and keyed as an unsigned 32-bit integer, value above row
// (`fold_argmax`, encoder_tail_common.cuh); a thread keeps the larger key of
// its two rows per column, and the 32 winners fold by the same reduce-scatter
// and an atomic max into the same 4-byte-per-channel table: exact and
// commutative, launches bit-equal. At the end the key gives out (already
// rounded and biased) and idx. Rows are 16 bits: P <= 65536.
#pragma once

#include "encoder_tail_common.cuh"

namespace catre {
namespace tail {

constexpr int kTile = 128;                 // points per tile
constexpr int kHalfTile = 64;              // rows of one consumer warpgroup
constexpr int kStageBytes = 16384;         // 128 weight rows x 64 columns, or 64 points x <= 128
constexpr int kStages = 5;
constexpr int kPanelBytes = kTile * wg::kRowBytes;   // one 64-column panel of the h tile
constexpr int kMaxHid = 512;               // the h tile is chid x 128 bf16: 128 KB at most
constexpr int kConsumerThreads = 256;
constexpr int kBlockThreads = kConsumerThreads + 128;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;   // 2 x 128 x 232 + 128 x 40 = 64512
constexpr int kAllConsumers = 3;           // named barrier ids: 1, 2 a warpgroup each; 3 both

// Shared memory, from a 1024-byte boundary: [h (chid / 64 panels of 128
// rows) | ring (kStages) | running max keys (cout) | full, empty (kStages each)].
struct Smem {
  unsigned char* h;
  Ring<kStages, kStageBytes> ring;
  int* gmax;
  __device__ Smem(unsigned char* raw, int chid, int cout) {
    h = raw + ((1024 - (wg::smem_addr(raw) & 1023)) & 1023);
    ring.slots = h + (chid / 64) * kPanelBytes;
    gmax = reinterpret_cast<int*>(ring.slots + kStages * kStageBytes);
    ring.full = reinterpret_cast<uint64_t*>(gmax + cout);
    ring.empty = ring.full + kStages;
  }
};

inline size_t smem_bytes(int chid, int cout) {
  return 1024 + static_cast<size_t>(chid / 64) * kPanelBytes +
         static_cast<size_t>(kStages) * kStageBytes + sizeof(int) * cout +
         sizeof(uint64_t) * 2 * kStages;
}

// GEMM1 chunk: acc = x rows @ W3[128 j : 128 j + 128]^T over the KX / 4 stages
// from sequence number n on; gives the stages back when the products are done.
template <int KX>
__device__ __forceinline__ void product_x(float (&acc)[64], uint32_t (&xa)[KX][4], const Smem& sm,
                                          uint32_t& n) {
  wg::pin_new(acc);
#pragma unroll
  for (int kp = 0; kp < KX / 4; ++kp) {
    const uint64_t desc = wg::panel_desc(sm.ring.await(n + kp));
#pragma unroll
    for (int q = 0; q < 4; ++q) wg::pin(xa[4 * kp + q]);
    wg::wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wg::wgmma_m64n128k16(acc, xa[4 * kp + q], desc + q * wg::kKStepUnits, kp > 0 || q > 0);
    wg::wgmma_commit();
  }
  wg::wgmma_wait();
  wg::pin(acc);
#pragma unroll
  for (int kp = 0; kp < KX / 4; ++kp) sm.ring.release(n + kp);
  n += KX / 4;
}

// GEMM2 chunk: acc = h rows @ W4[128 c : 128 c + 128]^T over chid / 64 stages;
// one group of products stays in flight while the stage before goes back.
__device__ __forceinline__ void product_h(float (&acc)[64], const unsigned char* h_rows,
                                          int n_panels, const Smem& sm, uint32_t& n) {
  wg::pin_new(acc);
#pragma unroll 1
  for (int kp = 0; kp < n_panels; ++kp) {
    const uint64_t b_desc = wg::panel_desc(sm.ring.await(n));
    const uint64_t a_desc = wg::panel_desc(h_rows + kp * kPanelBytes);
    wg::pin(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wg::wgmma_m64n128k16_ss(acc, a_desc + q * wg::kKStepUnits, b_desc + q * wg::kKStepUnits,
                              kp > 0 || q > 0);
    wg::wgmma_commit();
    if (kp > 0) {
      wg::wgmma_wait_pending<1>();
      sm.ring.release(n - 1);
    }
    ++n;
  }
  wg::wgmma_wait();
  wg::pin(acc);
  sm.ring.release(n - 1);
}

// Chunk j of an accumulator into the warpgroup's rows of the h tile, each
// element v of column c as the bf16 value of epi(v, b[128 j + c]): per pair of
// n-tiles one stmatrix of four 8 x 8 matrices (rows g / g + 8 of n-tile jj,
// then of jj + 1). Lane l addresses row (l % 8) + 8 ((l / 8) % 2) of n-tile
// jj + l / 16; panel and 16-byte chunk of that n-tile's 8 columns under the
// 128-byte swizzle (row % 8 = l % 8). K9's main column stores its h2 with it.
template <typename Epi>
__device__ __forceinline__ void store_tile(const float (&acc)[64], unsigned char* h, int j,
                                           const float* b, const Who& me, Epi epi) {
  const int row = kHalfTile * me.wgi + 16 * me.w + (me.lane & 7) + 8 * ((me.lane >> 3) & 1);
  const uint32_t row_addr = wg::smem_addr(h) + row * wg::kRowBytes;
#pragma unroll
  for (int jj = 0; jj < 16; jj += 2) {
    uint32_t r[4];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int k = 4 * (jj + d);
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b + 128 * j + 8 * (jj + d) + 2 * me.t));
      r[2 * d] = wg::pack_a(epi(acc[k], bb.x), epi(acc[k + 1], bb.y));
      r[2 * d + 1] = wg::pack_a(epi(acc[k + 2], bb.x), epi(acc[k + 3], bb.y));
    }
    const int col8 = 16 * j + jj + (me.lane >> 4);     // the n-tile's 8-column group in h
    const uint32_t addr = row_addr + (col8 >> 3) * kPanelBytes + (((col8 & 7) ^ (me.lane & 7)) << 4);
    wg::stmatrix_x4(addr, r[0], r[1], r[2], r[3]);
  }
}

// h = relu(round(round(acc) + b3)) of GEMM1 chunk j into the warpgroup's rows of the h tile.
__device__ __forceinline__ void store_h(const float (&acc)[64], unsigned char* h, int j,
                                        const float* b3, const Who& me) {
  store_tile(acc, h, j, b3, me, [](float v, float b) {
    return fmaxf(round_to<bf16>(round_to<bf16>(v) + b), 0.0f);
  });
}

#ifdef CATRE_K6F_BARE_FOLD
// diagnostic build (tools/probe_k1.py --train): the K6 forward folds the bare
// accumulator as K1 does and writes idx = 0, the time without the rounded fold
constexpr bool kBareFold = true;
#else
constexpr bool kBareFold = false;
#endif

// Fold a GEMM2 chunk into the running maxima of its 128 channels (`gmax` keys).
__device__ __forceinline__ void fold_max(const float (&acc)[64], bool ok0, bool ok1, int* gmax,
                                         const Who& me) {
  float v[32];
  rows_max(acc, ok0, ok1, v);
  fold_keys(v, gmax, me);
}

// KX: k-steps of GEMM1, cin / 16; kIdx: the K6 forward (out and idx)
template <int KX, bool kIdx>
__global__ void __launch_bounds__(kBlockThreads, 1)
dense_relu_dense_max_wgmma(const bf16* x, const unsigned char* w3p, const float* b3,
                           const unsigned char* w4p, const float* b4, MaxOut<kIdx> o, int P,
                           int chid, int cout) {
  constexpr int kCin = 16 * KX;
  constexpr bool kRounded = kIdx && !kBareFold;       // the argmax fold
  extern __shared__ unsigned char raw[];
  const Smem sm(raw, chid, cout);
  const int tid = threadIdx.x;
  const int n_tiles = (P + kTile - 1) / kTile;
  const int w3_stages = (KX / 4) * (chid / 128), w4_stages = (chid / 64) * (cout / 128);

  // the ring zeroed, so that x rows no copy fills hold finite values; the running maxima at
  // -inf (argmax keys: below every candidate)
  for (int i = tid; i < kStages * kStageBytes / 16; i += kBlockThreads)
    reinterpret_cast<uint4*>(sm.ring.slots)[i] = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < cout; c += kBlockThreads) sm.gmax[c] = kRounded ? 0 : order_key(-INFINITY);
  if (tid == 0) sm.ring.init(1, kConsumerThreads);   // every consumer thread gives back every stage
  wg::fence_proxy_async();
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---- producer: per tile the two x halves, W3's stages, W4's stages
    wg::reg_dealloc<kProducerRegs>();
    if (tid == kConsumerThreads) {
      const unsigned char* xb =
          reinterpret_cast<const unsigned char*>(x + static_cast<size_t>(blockIdx.x) * P * kCin);
      uint32_t n = 0;
      auto put = [&](const unsigned char* src, uint32_t bytes) { sm.ring.put(n++, src, bytes); };
      for (int i = 0; i < n_tiles; ++i) {
        for (int half = 0; half < 2; ++half) {
          const int r0 = i * kTile + half * kHalfTile;
          const int rows = max(0, min(kHalfTile, P - r0));
          put(xb + static_cast<size_t>(r0) * kCin * 2, static_cast<uint32_t>(rows) * kCin * 2);
        }
        for (int q = 0; q < w3_stages; ++q) put(w3p + static_cast<size_t>(q) * kStageBytes, kStageBytes);
#ifndef CATRE_K1_SKIP_W4_LOADS
        for (int q = 0; q < w4_stages; ++q) put(w4p + static_cast<size_t>(q) * kStageBytes, kStageBytes);
#else   // diagnostic build (tools/probe_k1.py --skip-w4): GEMM2 reads stale stages, no W4 traffic
        for (int q = 0; q < w4_stages; ++q) put(w4p, 0);
#endif
      }
    }
  } else {
    // ---- consumers
    wg::reg_alloc<kConsumerRegs>();
    const Who me;
    const unsigned char* h_rows = sm.h + me.wgi * kHalfTile * wg::kRowBytes;
    uint32_t n = 0;
#pragma unroll 1
    for (int i = 0; i < n_tiles; ++i) {
      const int r0 = i * kTile + kHalfTile * me.wgi + 16 * me.w + me.g;
      const bool ok0 = r0 < P, ok1 = r0 + 8 < P;
      // the two x stages: this warpgroup's rows are loaded, the other's given back
      uint32_t xa[KX][4];
      const uint32_t own = n + me.wgi;
      load_x(xa, sm.ring.await(own), me);
      sm.ring.await(n + 1 - me.wgi);
      sm.ring.release(n + 1 - me.wgi);
      n += 2;
#pragma unroll 1
      for (int j = 0; j < chid / 128; ++j) {
        float acc[64];
        product_x(acc, xa, sm, n);
        if (j == 0) sm.ring.release(own);   // the registers loaded from it have been read
        store_h(acc, sm.h, j, b3, me);
      }
      wg::fence_proxy_async();                // h, written by stmatrix, is read by wgmma
      wg::named_barrier(1 + me.wgi, 128);
#pragma unroll 1
      for (int c = 0; c < cout / 128; ++c) {
        float acc[64];
        product_h(acc, h_rows, chid / 64, sm, n);
        if constexpr (kRounded)
          fold_argmax(acc, b4 + 128 * c, ok0, ok1, kRowMask - r0,
                      reinterpret_cast<uint32_t*>(sm.gmax) + 128 * c, me);
        else
          fold_max(acc, ok0, ok1, sm.gmax + 128 * c, me);
      }
    }
    wg::named_barrier(kAllConsumers, kConsumerThreads);
    for (int c = tid; c < cout; c += kConsumerThreads) {
      const size_t at = static_cast<size_t>(blockIdx.x) * cout + c;
      if constexpr (kRounded) {
        const uint32_t key = static_cast<uint32_t>(sm.gmax[c]);
        o.out[at] = key_value(key);
        o.idx[at] = key_row(key);
      } else {
        o.out[at] = round_to<bf16>(round_to<bf16>(from_key(sm.gmax[c])) + b4[c]);
        if constexpr (kIdx) o.idx[at] = 0;
      }
    }
  }
}

template <int KX, bool kIdx>
int launch(const void* x, const void* w3p, const void* b3, const void* w4p, const void* b4,
           MaxOut<kIdx> o, int n, int p, int chid, int cout, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(dense_relu_dense_max_wgmma<KX, kIdx>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_relu_dense_max_wgmma<KX, kIdx><<<n, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const unsigned char*>(w3p),
      static_cast<const float*>(b3), static_cast<const unsigned char*>(w4p),
      static_cast<const float*>(b4), o, p, chid, cout);
  return static_cast<int>(cudaGetLastError());
}

// x (n, p, cin) bf16 with cin 64 or 128; w3p, w4p the repacked weights;
// chid a multiple of 128 up to kMaxHid, cout a multiple of 128; with kIdx
// (the K6 forward) 1 <= p <= kRowMask + 1.
template <bool kIdx>
int run(const void* x, const void* w3p, const void* b3, const void* w4p, const void* b4,
        MaxOut<kIdx> o, int n, int p, int cin, int chid, int cout, void* stream) {
  const size_t smem = smem_bytes(chid, cout);
  if ((cin != 64 && cin != 128) || chid % 128 || chid > kMaxHid || cout % 128 || smem > kSmemLimit ||
      (kIdx && (p < 1 || p > static_cast<int>(kRowMask) + 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  return cin == 128 ? launch<8>(x, w3p, b3, w4p, b4, o, n, p, chid, cout, smem, stream)
                    : launch<4>(x, w3p, b3, w4p, b4, o, n, p, chid, cout, smem, stream);
}

}  // namespace tail
}  // namespace catre
