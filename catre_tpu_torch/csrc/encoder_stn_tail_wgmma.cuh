// K2's bf16 build for Hopper: the conv3 -> max tails of both STNs
//   out[n, c] = max_p relu(round(round(x[n, p] . W[c]) + b[c])),
// x (N, P, cin) bf16, W (cout, cin) bf16, b f32 already rounded to bf16, out
// (N, cout) f32. It replaces the Pallas kernel
// catre_tpu/ops/pallas_encoder_epilogue.py::fused_dense_relu_max (:89, body
// _kernel_1 :41). With kIdx the same kernel is the bf16 training forward K5
// (catre_tpu/ops/pallas_encoder_epilogue_vjp.py::dense_relu_max_t, :263, body
// _fwd_kernel_1 :67), which also returns idx[n, c], the lowest row among the
// rows tied after rounding and the ReLU (`_per_cloud_max_argmax`, :38-48).
// The f32 builds stay on `encoder_epilogue.cuh`.
//
// What bounds it on the card: operations. 0.268 GFLOP per cloud of 1024
// points on 256 KB of input (1024 FLOP a byte); W is 256 KB.
//
// The design:
//   - a work item is (cloud n, channel group g), a group kChunks x 128
//     channels. The grid is G persistent blocks, G a multiple of the number of
//     groups (ops/encoder_epilogue.py::stn_tail_grid); block b keeps group b %
//     groups for its whole life and walks the clouds b / groups, + G / groups,
//     ... So each block stages its slice of W (kChunks x 32 KB, swizzled
//     panels) in shared memory once, and the blocks of one cloud's groups run
//     side by side: x comes from device memory once and from L2 once a group;
//   - the producer warpgroup (its registers go to the consumers by
//     `setmaxnreg`) streams x through a ring of kStages slots, 64 points a
//     slot, running from one cloud into the next without a break: each of its
//     128 threads copies 16-byte pieces by `cp.async` and arrives on the
//     slot's barrier when they have landed. A row of 256 bytes takes 256 +
//     kRowPad bytes of the slot, so that the eight rows an `ldmatrix` reads
//     lie on eight different bank groups; rows 256 bytes apart would share
//     one (an eight-way conflict). Neither one 16 KB bulk copy a slot into such
//     rows (0.27 ms at 512 clouds on an H100) nor a 256-byte bulk copy a row
//     into padded ones (0.61 ms: the copy engine takes about 67 SM clocks a
//     request) kept up with the products; the 16-byte copies do (0.20 ms,
//     and 0.19 ms with x loaded for a block's first cloud only). Rows past P
//     are not copied;
//   - two consumer warpgroups take the two slots of a 128-point tile, one
//     each: `ldmatrix` of their 64 rows into A registers, then per chunk 8
//     `wgmma.m64n128k16` with B from the resident panels. The accumulator is
//     folded into a running max held in registers, v[kChunks][32] (the max of
//     a thread's two rows per column; rows past P enter as -inf): no shuffle,
//     atomic or barrier inside a cloud. A slot goes back to the producer after
//     the first product that read its registers has completed;
//   - once per cloud: per chunk the eight row lanes reduce and scatter their
//     maxima and fold them by an atomic max on the float's order-preserving
//     integer image into a table of kChunks x 128 keys, double-buffered by the
//     cloud's parity; the 256 consumers meet at one named barrier; each channel
//     is rounded, biased, rounded and ReLU'd once, written as f32, and its key
//     reset. Rounding to nearest even, adding a constant and ReLU are monotone
//     non-decreasing, so max_p relu(round(round(a_p) + b)) = relu(round(
//     round(max_p a_p) + b)) exactly: flax Dense's rounding, applied once.
// With kIdx (the K5 forward) the value alone is not enough: the row must be
// the lowest whose own rounded, ReLU'd value equals the max, and rows that
// differ before rounding, or are negative before the ReLU, tie after it. So
// every element is rounded, biased (the group's bias pairs in shared memory,
// bf16x2), rounded and ReLU'd, and keyed as one unsigned integer, value above
// kRowMask - row (`encoder_tail_common.cuh::relu_keys`): the register that
// held a column's running max holds its running key, k[kChunks][32], and the
// fold once a cloud is the same reduce-scatter and an unsigned atomic max
// into the same table, reset to 0. The largest key decodes to the max and the
// lowest row that holds it, in any order of tiles, lanes and warpgroups; its
// value is the max of the same rounded values K2 takes, so `out` is K2's.
#pragma once

#include <type_traits>

#include "encoder_tail_common.cuh"

namespace catre {
namespace stn {

constexpr int kChunks = 2;                 // 128-channel chunks a block keeps: 4 groups at 1024
constexpr int kTile = 128;                 // points per tile
constexpr int kHalfTile = 64;              // rows of one consumer warpgroup
constexpr int kStages = 8;                 // ring slots, 64 rows each: four tiles in flight
constexpr int kRowPad = 16;                // bytes past each x row in a slot
constexpr int kProducerThreads = 128;      // the producer warpgroup: 128 arrivals fill a slot
constexpr int kPanelBytes = 128 * wg::kRowBytes;   // 128 weight rows x 64 columns
constexpr int kConsumerThreads = 256;
constexpr int kBlockThreads = kConsumerThreads + 128;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;   // 2 x 128 x 232 + 128 x 40 = 64512
constexpr int kAllConsumers = 1;           // named barrier id

#ifdef CATRE_K5F_BARE_FOLD
constexpr bool kBareFold = true;  // diagnostic build (tools/probe_k2.py --train): the K5 forward
                                  // folds the bare accumulator as K2 does and writes idx = 0
#else
constexpr bool kBareFold = false;
#endif

#ifdef CATRE_K2_SKIP_X_LOADS
constexpr bool kSkipX = true;    // diagnostic build (tools/probe_k2.py --skip-x): x lands for a
                                 // block's first cloud only, later clouds read stale slots
#else
constexpr bool kSkipX = false;
#endif

template <int KX>     // k-steps: cin / 16
constexpr int kLd = 32 * KX + kRowPad;     // bytes from one x row of a slot to the next
template <int KX>
constexpr int kSlotBytes = kHalfTile * kLd<KX>;
template <int KX, int C>
constexpr int kWeightBytes = C * (KX / 4) * kPanelBytes;

// Shared memory, from a 1024-byte boundary: [W (cin / 64 panels of 128 C rows)
// | ring (kStages slots) | keys (2 x C x 128) | full, empty (kStages each) |
// with kIdx: the group's bias pairs (C x 64 bf16x2)].
template <int KX, int C>
struct Smem {
  unsigned char* w;
  tail::Ring<kStages, kSlotBytes<KX>> ring;
  int* keys;
  uint32_t* bias2;
  __device__ Smem(unsigned char* raw) {
    w = raw + ((1024 - (wg::smem_addr(raw) & 1023)) & 1023);
    ring.slots = w + kWeightBytes<KX, C>;
    keys = reinterpret_cast<int*>(ring.slots + kStages * kSlotBytes<KX>);
    ring.full = reinterpret_cast<uint64_t*>(keys + 2 * C * 128);
    ring.empty = ring.full + kStages;
    bias2 = reinterpret_cast<uint32_t*>(ring.empty + kStages);
  }
};

template <int KX, int C, bool kIdx = false>
constexpr size_t smem_bytes() {
  return 1024 + kWeightBytes<KX, C> + static_cast<size_t>(kStages) * kSlotBytes<KX> +
         sizeof(int) * 2 * C * 128 + sizeof(uint64_t) * 2 * kStages +
         (kIdx ? sizeof(uint32_t) * C * 64 : 0);
}

// groups of C chunks that cover cout channels; the last may hold fewer chunks
template <int C>
__host__ __device__ constexpr int n_groups(int cout) {
  return (cout / 128 + C - 1) / C;
}

// KX: k-steps, cin / 16; C: chunks a group; kIdx: the K5 forward (out and idx)
template <int KX, int C, bool kIdx>
__global__ void __launch_bounds__(kBlockThreads, 1)
dense_relu_max_wgmma(const bf16* x, const bf16* w, const float* b, MaxOut<kIdx> o, int N, int P,
                     int cout) {
  constexpr int kCin = 16 * KX, kRowBytes = 2 * kCin, kPieces = kRowBytes / 16;
  constexpr bool kKeyed = kIdx && !kBareFold;        // the argmax fold
  using Run = std::conditional_t<kKeyed, uint32_t, float>;
  extern __shared__ unsigned char raw[];
  const Smem<KX, C> sm(raw);
  const int tid = threadIdx.x;
  const int groups = n_groups<C>(cout), stride = gridDim.x / groups;
  const int g = blockIdx.x % groups, first = blockIdx.x / groups;
  const int n_rows = 128 * min(C, cout / 128 - g * C);    // channels of this block's group
  const int n_tiles = (P + kTile - 1) / kTile;

  // the group's W rows as swizzled panels; the ring zeroed, so that rows no copy fills
  // hold finite values; both key tables at -inf (argmax keys: 0, below every candidate);
  // the keyed fold's bias pairs
  wg::stage_weight(sm.w, w + static_cast<size_t>(g) * C * 128 * kCin, kCin, n_rows, kCin, tid,
                   kBlockThreads);
  for (int i = tid; i < kStages * kSlotBytes<KX> / 16; i += kBlockThreads)
    reinterpret_cast<uint4*>(sm.ring.slots)[i] = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < 2 * C * 128; c += kBlockThreads)
    sm.keys[c] = kKeyed ? 0 : tail::order_key(-INFINITY);
  if constexpr (kKeyed)
    for (int i = tid; i < C * 64; i += kBlockThreads) {
      const float2 bb = 2 * i < n_rows ? *reinterpret_cast<const float2*>(b + g * C * 128 + 2 * i)
                                       : make_float2(0.0f, 0.0f);
      sm.bias2[i] = tail::bf2_bits(__floats2bfloat162_rn(bb.x, bb.y));
    }
  if (tid == 0) sm.ring.init(kProducerThreads, 128);   // the warpgroup that reads a slot gives it back
  wg::fence_proxy_async();
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---- producer: per cloud, per tile, the two 64-row halves, 16 bytes a thread and copy
    wg::reg_dealloc<kProducerRegs>();
    const int pt = tid - kConsumerThreads;
    uint32_t n = 0;
    for (int cloud = first; cloud < N; cloud += stride) {
      const unsigned char* xc =
          reinterpret_cast<const unsigned char*>(x + static_cast<size_t>(cloud) * P * kCin);
      for (int r0 = 0; r0 < n_tiles * kTile; r0 += kHalfTile, ++n) {
        const int rows = (kSkipX && cloud != first) ? 0 : max(0, min(kHalfTile, P - r0));
        const unsigned char* src = xc + static_cast<size_t>(r0) * kRowBytes;
        unsigned char* dst = sm.ring.claim(n);
        for (int i = pt; i < rows * kPieces; i += kProducerThreads)
          wg::cp_async16(dst + (i / kPieces) * kLd<KX> + (i % kPieces) * 16, src + 16 * i);
        wg::cp_async_arrive(&sm.ring.full[n % kStages]);
      }
    }
  } else {
    // ---- consumers: warpgroup wgi takes the slots n = 2 i + wgi of tiles i = 0, 1, ...
    wg::reg_alloc<kConsumerRegs>();
    const tail::Who me;
    const float bias = !kKeyed && tid < n_rows ? b[g * C * 128 + tid] : 0.0f;
    uint32_t n = me.wgi;
    int parity = 0;
#pragma unroll 1
    for (int cloud = first; cloud < N; cloud += stride, parity ^= 1) {
      Run v[C][32];      // a column's running max, or with kKeyed its running key
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if constexpr (kKeyed) v[c][i] = 0u;
          else v[c][i] = -INFINITY;
        }
#pragma unroll 1
      for (int i = 0; i < n_tiles; ++i, n += 2) {
        const int row0 = i * kTile + kHalfTile * me.wgi;
        uint32_t xa[KX][4];
        tail::load_x<KX, kLd<KX>>(xa, sm.ring.await(n), me);
        const bool whole = row0 + kHalfTile <= P;
        const int r = row0 + 16 * me.w + me.g;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (128 * c < n_rows) {
            float acc[64];
            wg::product<KX>(acc, xa, sm.w, n_rows, c);
            if (c == 0) sm.ring.release(n);    // the registers loaded from it have been read
            if constexpr (kKeyed) {
              const uint32_t row_bits = tail::kRowMask - static_cast<uint32_t>(r);
              if (whole) tail::relu_keys<false>(acc, sm.bias2 + 64 * c, true, true, row_bits, v[c], me);
              else tail::relu_keys<true>(acc, sm.bias2 + 64 * c, r < P, r + 8 < P, row_bits, v[c], me);
            } else {
              float m[32];
              if (whole) tail::rows_max(acc, m);
              else tail::rows_max(acc, r < P, r + 8 < P, m);
#pragma unroll
              for (int k = 0; k < 32; ++k) v[c][k] = fmaxf(v[c][k], m[k]);
            }
          }
        }
      }
      using Key = std::conditional_t<kKeyed, uint32_t, int>;
      Key* keys = reinterpret_cast<Key*>(sm.keys) + parity * C * 128;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (128 * c < n_rows) tail::fold_keys(v[c], keys + 128 * c, me);
      wg::named_barrier(kAllConsumers, kConsumerThreads);
      if (tid < n_rows) {
        const size_t at = static_cast<size_t>(cloud) * cout + g * C * 128 + tid;
        if constexpr (kKeyed) {
          o.out[at] = tail::relu_key_value(keys[tid]);
          o.idx[at] = tail::key_row(keys[tid]);
          keys[tid] = 0;
        } else {
          const float m = round_to<bf16>(round_to<bf16>(tail::from_key(keys[tid])) + bias);
          o.out[at] = fmaxf(m, 0.0f);
          if constexpr (kIdx) o.idx[at] = 0;
          keys[tid] = tail::order_key(-INFINITY);
        }
      }
    }
  }
}

template <int KX, int C, bool kIdx>
int launch(const void* x, const void* w, const void* b, MaxOut<kIdx> o, int n, int p, int cout,
           int grid, void* stream) {
  constexpr size_t smem = smem_bytes<KX, C, kIdx>();
  cudaError_t err = cudaFuncSetAttribute(dense_relu_max_wgmma<KX, C, kIdx>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_relu_max_wgmma<KX, C, kIdx><<<grid, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(b), o, n,
      p, cout);
  return static_cast<int>(cudaGetLastError());
}

// x (n, p, cin) bf16 with cin 64 or 128, 16-byte aligned; w (cout, cin) bf16;
// b (cout) f32 rounded to bf16; cout a multiple of 128; grid a multiple of
// n_groups<C>(cout), at most n times it; with kIdx (the K5 forward) p at most
// kRowMask + 1.
template <int C, bool kIdx>
inline int run(const void* x, const void* w, const void* b, MaxOut<kIdx> o, int n, int p, int cin,
               int cout, int grid, void* stream) {
  const int groups = n_groups<C>(cout);
  if ((cin != 64 && cin != 128) || cout <= 0 || cout % 128 || n < 1 || p < 1 || grid < groups ||
      grid % groups || grid / groups > n || (kIdx && p > static_cast<int>(tail::kRowMask) + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return cin == 128 ? launch<8, C>(x, w, b, o, n, p, cout, grid, stream)
                    : launch<4, C>(x, w, b, o, n, p, cout, grid, stream);
}

}  // namespace stn
}  // namespace catre
