// K9's bf16 build for Hopper: a PointNet column of three dense layers fused
// with the per-cloud max,
//   h1 = round(relu(x @ W1^T + b1)),  h2 = round(relu(h1 @ W2^T + b2)),
//   out[n, c] = max_p (h2 @ W3^T + b3)[p, c], then a ReLU if relu_last,
// x (N, P, cin) and the weights bf16, biases f32, out (N, c3) f32. It
// replaces the Pallas kernel catre_tpu/ops/pallas_encoder.py::chain3_max
// (:55, body _chain_kernel :25, call :78). The rounding is _chain_kernel's
// (:35-42), not flax Dense's that K1 and K2 follow: products accumulated in
// f32, the f32 bias added in f32, one rounding to bf16 per hidden layer after
// the ReLU, the last layer left in f32. fl(a + b3) and the ReLU are monotone
// non-decreasing in a, so max_p relu(fl(a_p + b3)) = relu(fl(max_p a_p + b3))
// exactly: the max runs on the bare accumulator, and the bias and the ReLU of
// the last layer are applied once per (cloud, channel). The f32 build stays
// on `gemm_tile` (encoder_chain.cu) and serves checks.
//
// What bounds it on the card: operations. The main column does 598,016 MACs
// a point on 128 input bytes, the STN columns 143,360 (stnkd) and 131,264
// (stn3d) on 128 and 6.
//
// Two designs, both on the `wgmma` kernels of K1 and K2, with the hidden
// layers chained through registers (wgmma_tile.cuh's note: the accumulator of
// one product, rounded and packed by `pack_a`, is the A registers of the
// next). No hidden activation goes to device memory, and h1 goes through no
// shared memory.
//   - main (64 -> 128 -> c2 <= 512 -> c3), `chain3_main_wgmma`: K1's kernel
//     (encoder_tail_wgmma.cuh) with a layer in front. One block per cloud,
//     128-point tiles, two consumer warpgroups of 64 rows, one producer thread
//     streaming 16 KB bulk-copy stages in the order the wrapper packed the
//     weights (ops/encoder_epilogue.py::pack_panels): per tile the two x halves,
//     W1 (one stage), W2 (2 c2 / 128 stages), W3 (c2 / 64 x c3 / 128). Layer
//     1 is one m64n128k16 chain of 4 k-steps, A by ldmatrix of the warpgroup's
//     x rows; its epilogue leaves h1 as the 8 k-steps of layer 2's A
//     registers. Layer 2 runs per 128-channel chunk with B from the ring; its
//     epilogue writes h2 by stmatrix into K1's h tile (128 x c2 bf16, swizzled
//     K-major panels). Layer 3 and the fold are K1's GEMM2 and fold as they
//     stand: per 128-channel chunk, wgmma from shared memory, the max of the
//     bare accumulator (rows past P as -inf), the reduce-scatter and an atomic
//     max on the order image into a table of c3 keys: commutative, launches
//     bit-equal;
//   - STN (3 or 64 -> 64 -> 128 -> c3), `chain3_stn_wgmma`: K2's persistent
//     kernel (encoder_stn_tail_wgmma.cuh) with two layers in front. Block b
//     keeps channel group b % groups of W3 (kChunks x 128 rows) resident with
//     all of W1 and W2, and walks the clouds b / groups, + grid / groups, ...
//     (ops/encoder_epilogue.py::stn_tail_grid). For cin = 64 the producer
//     warpgroup streams x through K2's cp.async ring into padded rows; layer 1
//     is `product_n64` (4 k-steps, 64 outputs), A by ldmatrix. For cin = 3 a
//     bf16 row is 6 bytes, which suits neither cp.async nor ldmatrix, and no
//     padded copy of x exists in device memory: the producer loads x as
//     scalars and stores each row into the first 3 of 16 columns of a ring
//     slot whose other columns stay 0, and layer 1 is one k-step of
//     `product_n64` against W1 staged as a panel with 61 zero columns. Either
//     way h1 is packed into layer 2's 4 k-steps of A, layer 2 (`product`, 64
//     x 128) leaves h2 as layer 3's 8 k-steps, and layer 3 is 8 m64n128k16
//     per chunk, folded into a running max in registers, v[kChunks][32], with
//     K2's fold once a cloud. Each channel group recomputes the front for its
//     cloud: with kChunks = 2, four times at c3 = 1024 (stnkd 180,224 MACs a
//     point against 143,360). A larger slice would hold v[4][32], 128
//     registers beside layer 3's 64-float accumulator and h2's 32 A
//     registers, past the consumers' 232.
#pragma once

#include "encoder_stn_tail_wgmma.cuh"
#include "encoder_tail_wgmma.cuh"

namespace catre {
namespace chain {

using tail::Who;

constexpr int kChunks = stn::kChunks;      // 128-channel chunks of W3 an STN block keeps
constexpr int kMainCin = 64, kMainC1 = 128;
constexpr int kStnC1 = 64, kStnC2 = 128;

// h = round(relu(d + b)) of a 64 x 8 NT accumulator (columns 8 j + 2 t + e of
// n-tile j), packed as the A registers of the next product: k-step s is
// n-tiles 2 s (a[s][0], a[s][1]) and 2 s + 1 (a[s][2], a[s][3]). b is f32.
template <int NT>
__device__ __forceinline__ void relu_pack(const float (&d)[4 * NT], const float* b,
                                          uint32_t (&a)[NT / 2][4], const Who& me) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + 8 * j + 2 * me.t));
    a[j / 2][2 * (j % 2)] = wg::pack_a(fmaxf(d[4 * j] + bb.x, 0.0f), fmaxf(d[4 * j + 1] + bb.y, 0.0f));
    a[j / 2][2 * (j % 2) + 1] =
        wg::pack_a(fmaxf(d[4 * j + 2] + bb.x, 0.0f), fmaxf(d[4 * j + 3] + bb.y, 0.0f));
  }
}

// The same rounding of a 64 x 128 accumulator into the warpgroup's rows of
// chunk j of K1's h tile.
__device__ __forceinline__ void store_h_relu(const float (&acc)[64], unsigned char* h, int j,
                                             const float* b, const Who& me) {
  tail::store_tile(acc, h, j, b, me, [](float v, float bias) { return fmaxf(v + bias, 0.0f); });
}

__device__ __forceinline__ float last_layer(int key, float b, int relu_last) {
  const float m = tail::from_key(key) + b;
  return relu_last ? fmaxf(m, 0.0f) : m;
}

// ---- main: K1's kernel with a layer in front -----------------------------------
// KX: k-steps of layer 1, cin / 16
template <int KX>
__global__ void __launch_bounds__(tail::kBlockThreads, 1)
chain3_main_wgmma(const bf16* x, const unsigned char* w1p, const float* b1,
                  const unsigned char* w2p, const float* b2, const unsigned char* w3p,
                  const float* b3, float* out, int P, int c2, int c3, int relu_last) {
  using tail::kBlockThreads;
  using tail::kConsumerThreads;
  using tail::kHalfTile;
  using tail::kTile;
  constexpr int kCin = 16 * KX, kStage = tail::kStageBytes;
  extern __shared__ unsigned char raw[];
  const tail::Smem sm(raw, c2, c3);
  const int tid = threadIdx.x;
  const int n_tiles = (P + kTile - 1) / kTile;
  const int w1_stages = KX / 4, w2_stages = (kMainC1 / 64) * (c2 / 128),
            w3_stages = (c2 / 64) * (c3 / 128);

  // the ring zeroed, so that x rows no copy fills hold finite values; the running maxima at -inf
  for (int i = tid; i < tail::kStages * kStage / 16; i += kBlockThreads)
    reinterpret_cast<uint4*>(sm.ring.slots)[i] = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < c3; c += kBlockThreads) sm.gmax[c] = tail::order_key(-INFINITY);
  if (tid == 0) sm.ring.init(1, kConsumerThreads);   // every consumer thread gives back every stage
  wg::fence_proxy_async();
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---- producer: per tile the two x halves, W1's, W2's and W3's stages
    wg::reg_dealloc<tail::kProducerRegs>();
    if (tid == kConsumerThreads) {
      const unsigned char* xb =
          reinterpret_cast<const unsigned char*>(x + static_cast<size_t>(blockIdx.x) * P * kCin);
      uint32_t n = 0;
      auto put = [&](const unsigned char* src, uint32_t bytes) { sm.ring.put(n++, src, bytes); };
      auto put_all = [&](const unsigned char* w, int stages) {
        for (int q = 0; q < stages; ++q) put(w + static_cast<size_t>(q) * kStage, kStage);
      };
      for (int i = 0; i < n_tiles; ++i) {
        for (int half = 0; half < 2; ++half) {
          const int r0 = i * kTile + half * kHalfTile;
          const int rows = max(0, min(kHalfTile, P - r0));
          put(xb + static_cast<size_t>(r0) * kCin * 2, static_cast<uint32_t>(rows) * kCin * 2);
        }
        put_all(w1p, w1_stages);
        put_all(w2p, w2_stages);
        put_all(w3p, w3_stages);
      }
    }
  } else {
    // ---- consumers
    wg::reg_alloc<tail::kConsumerRegs>();
    const Who me;
    const unsigned char* h_rows = sm.h + me.wgi * kHalfTile * wg::kRowBytes;
    uint32_t n = 0;
#pragma unroll 1
    for (int i = 0; i < n_tiles; ++i) {
      const int r0 = i * kTile + kHalfTile * me.wgi + 16 * me.w + me.g;
      const bool ok0 = r0 < P, ok1 = r0 + 8 < P;
      // layer 1: this warpgroup's x rows loaded, the other's stage given back; h1 stays
      // in registers as layer 2's A
      uint32_t h1[kMainC1 / 16][4];
      {
        uint32_t xa[KX][4];
        const uint32_t own = n + me.wgi;
        tail::load_x(xa, sm.ring.await(own), me);
        sm.ring.await(n + 1 - me.wgi);
        sm.ring.release(n + 1 - me.wgi);
        n += 2;
        float acc[64];
        tail::product_x(acc, xa, sm, n);
        sm.ring.release(own);               // the registers loaded from it have been read
        relu_pack<16>(acc, b1, h1, me);
      }
      // layer 2 per 128-channel chunk into the warpgroup's rows of the h tile
#pragma unroll 1
      for (int j = 0; j < c2 / 128; ++j) {
        float acc[64];
        tail::product_x(acc, h1, sm, n);
        store_h_relu(acc, sm.h, j, b2, me);
      }
      wg::fence_proxy_async();              // h, written by stmatrix, is read by wgmma
      wg::named_barrier(1 + me.wgi, 128);
      // layer 3 per 128-channel chunk, folded into the running maxima
#pragma unroll 1
      for (int c = 0; c < c3 / 128; ++c) {
        float acc[64];
        tail::product_h(acc, h_rows, c2 / 64, sm, n);
        tail::fold_max(acc, ok0, ok1, sm.gmax + 128 * c, me);
      }
    }
    wg::named_barrier(tail::kAllConsumers, kConsumerThreads);
    for (int c = tid; c < c3; c += kConsumerThreads)
      out[static_cast<size_t>(blockIdx.x) * c3 + c] = last_layer(sm.gmax[c], b3[c], relu_last);
  }
}

inline size_t main_smem_bytes(int c2, int c3) { return tail::smem_bytes(c2, c3); }

// ---- STN: K2's persistent kernel with two layers in front -------------------------
// Layer 1's k-steps: cin / 16, or one for cin = 3, whose rows the producer
// pads with zeros to 16 columns in the ring.
template <int kCin>
constexpr int kKx1 = kCin == 3 ? 1 : kCin / 16;
constexpr int kW1Bytes = kStnC1 * wg::kRowBytes;                          // one panel, K <= 64
constexpr int kW2Bytes = kStnC2 * wg::kRowBytes;                          // one panel, K = 64
constexpr int kW3Bytes = kChunks * (kStnC2 / 64) * stn::kPanelBytes;     // the group's slice
template <int kCin>
constexpr int kRingBytes = stn::kStages * stn::kSlotBytes<kKx1<kCin>>;

// Shared memory, from a 1024-byte boundary: [W3 slice (2 panels of the group's rows) |
// W2 (one panel) | W1 (one panel) | ring | keys (2 x kChunks x 128) | full, empty
// (stn::kStages each)].
template <int kCin>
struct StnSmem {
  unsigned char* w3;
  unsigned char* w2;
  unsigned char* w1;
  tail::Ring<stn::kStages, stn::kSlotBytes<kKx1<kCin>>> ring;
  int* keys;
  __device__ StnSmem(unsigned char* raw) {
    w3 = raw + ((1024 - (wg::smem_addr(raw) & 1023)) & 1023);
    w2 = w3 + kW3Bytes;
    w1 = w2 + kW2Bytes;
    ring.slots = w1 + kW1Bytes;
    keys = reinterpret_cast<int*>(ring.slots + kRingBytes<kCin>);
    ring.full = reinterpret_cast<uint64_t*>(keys + 2 * kChunks * 128);
    ring.empty = ring.full + stn::kStages;
  }
};

template <int kCin>
constexpr size_t stn_smem_bytes() {
  return 1024 + kW3Bytes + kW2Bytes + kW1Bytes + kRingBytes<kCin> +
         sizeof(int) * 2 * kChunks * 128 + sizeof(uint64_t) * 2 * stn::kStages;
}

// W1 (64 x 3) as the panel of a 64 x 64 weight whose other columns are 0:
// each thread writes whole 16-byte chunks, the first of a row holding W1's
// three values.
__device__ __forceinline__ void stage_w1_cin3(unsigned char* dst, const bf16* w1, int tid,
                                              int n_threads) {
  const auto* w = reinterpret_cast<const unsigned short*>(w1);
  for (int i = tid; i < kStnC1 * 8; i += n_threads) {
    const int n = i / 8, c = i % 8;
    const uint4 v = c ? make_uint4(0, 0, 0, 0)
                      : make_uint4(w[3 * n] | (static_cast<uint32_t>(w[3 * n + 1]) << 16),
                                   w[3 * n + 2], 0, 0);
    *reinterpret_cast<uint4*>(dst + n * wg::kRowBytes + ((c ^ (n & 7)) << 4)) = v;
  }
}

template <int kCin>
__global__ void __launch_bounds__(stn::kBlockThreads, 1)
chain3_stn_wgmma(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
                 const bf16* w3, const float* b3, float* out, int N, int P, int c3, int relu_last) {
  using stn::kTile;
  using stn::kHalfTile;
  using stn::kConsumerThreads;
  using stn::kBlockThreads;
  constexpr int KX1 = kKx1<kCin>, kLd = stn::kLd<KX1>;
  extern __shared__ unsigned char raw[];
  const StnSmem<kCin> sm(raw);
  const int tid = threadIdx.x;
  const int groups = stn::n_groups<kChunks>(c3), stride = gridDim.x / groups;
  const int g = blockIdx.x % groups, first = blockIdx.x / groups;
  const int n_rows = 128 * min(kChunks, c3 / 128 - g * kChunks);   // W3 rows of this group
  const int n_tiles = (P + kTile - 1) / kTile;

  // the group's W3 rows, W2 and W1 as swizzled panels; the ring zeroed, so that rows no
  // copy fills hold finite values (and, at cin = 3, the padding columns hold 0); both key
  // tables at -inf
  wg::stage_weight(sm.w3, w3 + static_cast<size_t>(g) * kChunks * 128 * kStnC2, kStnC2, n_rows,
                   kStnC2, tid, kBlockThreads);
  wg::stage_weight(sm.w2, w2, kStnC1, kStnC2, kStnC1, tid, kBlockThreads);
  if constexpr (kCin == 3) stage_w1_cin3(sm.w1, w1, tid, kBlockThreads);
  else wg::stage_weight(sm.w1, w1, kCin, kStnC1, kCin, tid, kBlockThreads);
  for (int i = tid; i < kRingBytes<kCin> / 16; i += kBlockThreads)
    reinterpret_cast<uint4*>(sm.ring.slots)[i] = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < 2 * kChunks * 128; c += kBlockThreads) sm.keys[c] = tail::order_key(-INFINITY);
  if (tid == 0) sm.ring.init(stn::kProducerThreads, 128);   // the reading warpgroup gives a slot back
  wg::fence_proxy_async();
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---- producer: per cloud, per tile, the two 64-row halves. cin = 64: 16 bytes a
    // thread and cp.async. cin = 3 (6-byte rows, which suit neither cp.async nor
    // ldmatrix): one value a thread and load, issued before the slot is claimed so that
    // it lands while the producer waits, stored into the first 3 of the row's 16 columns
    wg::reg_dealloc<stn::kProducerRegs>();
    const int pt = tid - kConsumerThreads;
    uint32_t n = 0;
    for (int cloud = first; cloud < N; cloud += stride) {
      const bf16* xc = x + static_cast<size_t>(cloud) * P * kCin;
      for (int r0 = 0; r0 < n_tiles * kTile; r0 += kHalfTile, ++n) {
        const int rows = max(0, min(kHalfTile, P - r0));
        if constexpr (kCin == 3) {
          const auto* src = reinterpret_cast<const unsigned short*>(xc + static_cast<size_t>(r0) * 3);
          unsigned short v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) v[q] = pt + 128 * q < rows * 3 ? src[pt + 128 * q] : 0;
          unsigned char* dst = sm.ring.claim(n);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int i = pt + 128 * q;
            if (i < rows * 3) *reinterpret_cast<unsigned short*>(dst + (i / 3) * kLd + (i % 3) * 2) = v[q];
          }
          wg::mbar_arrive(&sm.ring.full[n % stn::kStages]);
        } else {
          constexpr int kPieces = 2 * kCin / 16;
          const unsigned char* src = reinterpret_cast<const unsigned char*>(xc) +
                                     static_cast<size_t>(r0) * 2 * kCin;
          unsigned char* dst = sm.ring.claim(n);
          for (int i = pt; i < rows * kPieces; i += stn::kProducerThreads)
            wg::cp_async16(dst + (i / kPieces) * kLd + (i % kPieces) * 16, src + 16 * i);
          wg::cp_async_arrive(&sm.ring.full[n % stn::kStages]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi takes the slots n = 2 i + wgi of tiles i = 0, 1, ...
    wg::reg_alloc<stn::kConsumerRegs>();
    const Who me;
    uint32_t n = me.wgi;
    int parity = 0;
#pragma unroll 1
    for (int cloud = first; cloud < N; cloud += stride, parity ^= 1) {
      float v[kChunks][32];      // a column's running max of the bare accumulator
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int k = 0; k < 32; ++k) v[c][k] = -INFINITY;
#pragma unroll 1
      for (int i = 0; i < n_tiles; ++i, n += 2) {
        const int row0 = i * kTile + kHalfTile * me.wgi;
        const int r = row0 + 16 * me.w + me.g;
        // layer 1 -> h1, layer 2's 4 k-steps of A
        uint32_t h1[kStnC1 / 16][4];
        {
          uint32_t xa[KX1][4];
          tail::load_x<KX1, kLd>(xa, sm.ring.await(n), me);
          float d1[32];
          wg::product_n64<KX1, 0>(d1, xa, sm.w1, wg::kKStepUnits, 0);
          sm.ring.release(n);              // the registers loaded from it have been read
          relu_pack<8>(d1, b1, h1, me);
        }
        // layer 2 -> h2, layer 3's 8 k-steps of A
        uint32_t h2[kStnC2 / 16][4];
        {
          float d2[64];
          wg::product<kStnC1 / 16>(d2, h1, sm.w2, kStnC2, 0);
          relu_pack<16>(d2, b2, h2, me);
        }
        // layer 3 per chunk, folded into the running max (rows past P as -inf)
        const bool whole = row0 + kHalfTile <= P;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (128 * c < n_rows) {
            float acc[64];
            wg::product<kStnC2 / 16>(acc, h2, sm.w3, n_rows, c);
            float m[32];
            if (whole) tail::rows_max(acc, m);
            else tail::rows_max(acc, r < P, r + 8 < P, m);
#pragma unroll
            for (int k = 0; k < 32; ++k) v[c][k] = fmaxf(v[c][k], m[k]);
          }
        }
      }
      // once a cloud: fold, meet, bias (+ ReLU) and write each channel, reset its key
      int* keys = sm.keys + parity * kChunks * 128;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        if (128 * c < n_rows) tail::fold_keys(v[c], keys + 128 * c, me);
      wg::named_barrier(stn::kAllConsumers, kConsumerThreads);
      if (tid < n_rows) {
        const int ch = g * kChunks * 128 + tid;
        out[static_cast<size_t>(cloud) * c3 + ch] = last_layer(keys[tid], b3[ch], relu_last);
        keys[tid] = tail::order_key(-INFINITY);
      }
    }
  }
}

// ---- launchers -----------------------------------------------------------------
// Which design takes these widths: 1 main, 2 STN, 0 none.
inline int design(int cin, int c1, int c2, int c3) {
  if (c3 <= 0 || c3 % 128) return 0;
  if (cin == kMainCin && c1 == kMainC1 && c2 > 0 && c2 % 128 == 0 && c2 <= tail::kMaxHid &&
      main_smem_bytes(c2, c3) <= tail::kSmemLimit)
    return 1;
  if ((cin == 3 || cin == 64) && c1 == kStnC1 && c2 == kStnC2) return 2;
  return 0;
}

inline size_t smem_bytes(int cin, int c1, int c2, int c3) {
  switch (design(cin, c1, c2, c3)) {
    case 1: return main_smem_bytes(c2, c3);
    case 2: return cin == 3 ? stn_smem_bytes<3>() : stn_smem_bytes<64>();
    default: return 0;
  }
}

template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, int grid, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, tail::kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// x (n, p, cin) bf16; main: w1p, w2p, w3p the weights repacked as 16 KB stages
// (pack_panels), grid unused; STN: w1 (64, cin), w2 (128, 64), w3 (c3, 128)
// bf16 as they are, grid a multiple of n_groups<kChunks>(c3), at most n times
// it. Biases f32; out (n, c3) f32. x starts on a 16-byte boundary for cin = 64.
inline int run(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* w3, const void* b3, void* out, int n, int p, int cin, int c1, int c2,
               int c3, int relu_last, int grid, void* stream) {
  const int which = design(cin, c1, c2, c3);
  if (which == 0 || n < 1 || p < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* fb1 = static_cast<const float*>(b1);
  const auto* fb2 = static_cast<const float*>(b2);
  const auto* fb3 = static_cast<const float*>(b3);
  auto* o = static_cast<float*>(out);
  const size_t smem = smem_bytes(cin, c1, c2, c3);
  if (which == 1)
    return launch_kernel(chain3_main_wgmma<kMainCin / 16>, n, smem, stream, xb,
                  static_cast<const unsigned char*>(w1), fb1, static_cast<const unsigned char*>(w2),
                  fb2, static_cast<const unsigned char*>(w3), fb3, o, p, c2, c3, relu_last);
  const int groups = stn::n_groups<kChunks>(c3);
  if (grid < groups || grid % groups || grid / groups > n) return static_cast<int>(cudaErrorInvalidValue);
  const auto* bw1 = static_cast<const bf16*>(w1);
  const auto* bw2 = static_cast<const bf16*>(w2);
  const auto* bw3 = static_cast<const bf16*>(w3);
  if (cin == 3)
    return launch_kernel(chain3_stn_wgmma<3>, grid, smem, stream, xb, bw1, fb1, bw2, fb2, bw3, fb3, o, n,
                  p, c3, relu_last);
  return launch_kernel(chain3_stn_wgmma<64>, grid, smem, stream, xb, bw1, fb1, bw2, fb2, bw3, fb3, o, n, p,
                c3, relu_last);
}

}  // namespace chain
}  // namespace catre
