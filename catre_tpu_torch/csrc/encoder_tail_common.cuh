// What the two `wgmma` encoder tails share: K1's bf16 build
// (encoder_tail_wgmma.cuh, the main conv3 -> conv4 -> max tail) and K2's
// (encoder_stn_tail_wgmma.cuh, the STN conv3 -> max tails). Both run blocks of
// two consumer warpgroups and one producer warpgroup that feeds x rows through
// a ring of shared-memory stages (K1 by 1-D bulk copies, K2 by 16-byte
// `cp.async`); both take the max over points on the bare f32 accumulator and
// round once per (cloud, channel). K1's body with kIdx is also the bf16 K6
// forward, and K2's the bf16 K5 forward: both need the lowest row among the
// rows tied after rounding. Here: a consumer thread's coordinates, the ring,
// the A registers of x rows, the order-preserving integer image of a float,
// the max over the row lanes of a fragment with its fold into a table of
// running maxima, and the argmax keys of the K6 and K5 forwards with their
// folds.
#pragma once

#include "common.cuh"
#include "wgmma_tile.cuh"

namespace catre {
namespace tail {

constexpr size_t kSmemLimit = 232448;     // dynamic shared memory one block may ask for on sm_90

// A consumer thread: warpgroup wgi, warp w of it, lane = 4 g + t.
struct Who {
  int wgi, w, lane, g, t;
  __device__ Who() {
    wgi = threadIdx.x / 128;
    w = (threadIdx.x / 32) % 4;
    lane = threadIdx.x % 32;
    g = lane / 4;
    t = lane % 4;
  }
};

// A ring of kStages slots of kSlotBytes in shared memory, filled by the
// producer's copies and given back by the consumers, in one sequence of stages n = 0, 1,
// ...: stage n lives in slot n % kStages; its `full` barrier completes when
// its bytes have landed, its `empty` barrier when every consumer that waits
// for it has given it back.
template <int kStages, int kSlotBytes>
struct Ring {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;

  __device__ unsigned char* slot(uint32_t n) const { return slots + (n % kStages) * kSlotBytes; }
  // one thread, before the block-wide sync: `producers` arrivals (with their
  // bytes) complete `full`, `consumers` arrivals complete `empty`
  __device__ void init(int producers, int consumers) const {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], producers);
      wg::mbar_init(&empty[s], consumers);
    }
    wg::mbar_init_fence();
  }
  // consumer: wait until stage n's bytes have landed
  __device__ const unsigned char* await(uint32_t n) const {
    wg::mbar_wait(&full[n % kStages], (n / kStages) & 1);
    return slot(n);
  }
  __device__ void release(uint32_t n) const { wg::mbar_arrive(&empty[n % kStages]); }
  // producer: wait until stage n's slot has been given back
  __device__ unsigned char* claim(uint32_t n) const {
    wg::mbar_wait(&empty[n % kStages], ((n / kStages) & 1) ^ 1);
    return slot(n);
  }
  // producer, one thread: stage n is `bytes` from `src` in one bulk copy (0:
  // nothing lands, the consumers read what the slot held)
  __device__ void put(uint32_t n, const void* src, uint32_t bytes) const {
    unsigned char* dst = claim(n);
    if (bytes) {
      wg::mbar_arrive_expect_tx(&full[n % kStages], bytes);
      wg::bulk_copy(dst, src, bytes, &full[n % kStages]);
    } else {
      wg::mbar_arrive(&full[n % kStages]);
    }
  }
};

// The A registers of a product over x: the warpgroup's 64 x rows of a stage
// (rows kLd bytes apart, 32 KX of them used), KX k-steps for warp w.
template <int KX, int kLd = 32 * KX>
__device__ __forceinline__ void load_x(uint32_t (&a)[KX][4], const unsigned char* stage,
                                       const Who& me) {
  const uint32_t base = wg::smem_addr(stage) + (16 * me.w + me.lane % 16) * kLd + (me.lane / 16) * 16;
#pragma unroll
  for (int s = 0; s < KX; ++s)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[s][0]), "=r"(a[s][1]), "=r"(a[s][2]), "=r"(a[s][3])
                 : "r"(base + s * 32)
                 : "memory");
}

// An order-preserving integer image of a float (not NaN): a < b as floats
// if and only if key(a) < key(b) as signed integers; -0 sorts below +0.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float from_key(int k) { return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF); }

// The max of a 64 x 128 accumulator's two rows per thread, column by column:
// v[2 jj + e] is column 8 jj + 2 t + e; rows at or past P (ok0: row g, ok1:
// row g + 8 below P) enter as -inf.
__device__ __forceinline__ void rows_max(const float (&acc)[64], bool ok0, bool ok1, float (&v)[32]) {
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = acc[4 * jj + e], b = acc[4 * jj + 2 + e];
      v[2 * jj + e] = ok1 ? fmaxf(a, b) : (ok0 ? a : -INFINITY);
    }
}
// The same where both rows lie below P.
__device__ __forceinline__ void rows_max(const float (&acc)[64], float (&v)[32]) {
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) v[2 * jj + e] = fmaxf(acc[4 * jj + e], acc[4 * jj + 2 + e]);
}

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) { return max(a, b); }

// One step of the reduce-scatter below: lanes that differ in bit kHalf swap
// halves, each keeps the max of the half it owns.
template <int kHalf, typename T>
__device__ __forceinline__ void scatter_step(T (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const T send = upper ? v[i] : v[i + kHalf];
    const T keep = upper ? v[i + kHalf] : v[i];
    v[i] = vmax(keep, __shfl_xor_sync(0xffffffffu, send, kHalf));
  }
}

// The max over the eight row lanes (lane bits 4, 3, 2 = g bits 2, 1, 0) of 32
// column values, reduced and scattered in 28 shuffles: afterwards lane (g, t)
// holds in v[i], i = 0 .. 3, the max of column `scattered_column(i, me)`.
template <typename T>
__device__ __forceinline__ void reduce_scatter(T (&v)[32], const Who& me) {
  scatter_step<16>(v, me.lane);
  scatter_step<8>(v, me.lane);
  scatter_step<4>(v, me.lane);
}
__device__ __forceinline__ int scattered_column(int i, const Who& me) {
  return 16 * me.g + 8 * (i / 2) + 2 * me.t + i % 2;
}

// Fold the 32 column values of `rows_max` into the running maxima of their
// 128 channels (`keys`, order keys in shared memory) by an atomic max on each
// lane's four keys after `reduce_scatter`. Exact and commutative: the table
// does not depend on the order of arrival. v is overwritten.
__device__ __forceinline__ void fold_keys(float (&v)[32], int* keys, const Who& me) {
  reduce_scatter(v, me);
#pragma unroll
  for (int i = 0; i < 4; ++i) atomicMax(keys + scattered_column(i, me), order_key(v[i]));
}
// The same for 32 columns' unsigned argmax keys (below): an unsigned atomic max.
__device__ __forceinline__ void fold_keys(uint32_t (&k)[32], uint32_t* keys, const Who& me) {
  reduce_scatter(k, me);
#pragma unroll
  for (int i = 0; i < 4; ++i) atomicMax(keys + scattered_column(i, me), k[i]);
}

// ---- the argmax keys of the K6 forward
// A candidate (v, row) for a channel's max is one unsigned 32-bit key: the
// high 16 bits order v, a bf16 value, with -0 equal to +0 (`order2`); the low
// kRowBits bits are kRowMask - row. The largest key holds the largest value
// and, among equal values, the lowest row: the rule of the Pallas forward,
// jnp.min(jnp.where(blk == m, row, P)) over the rounded values
// (catre_tpu/ops/pallas_encoder_epilogue_vjp.py:38-48), where blk == m holds
// -0 and +0 equal. An unsigned atomic max on a table of keys is exact and
// commutative, so warpgroups, lanes and tiles may arrive in any order. Every
// candidate's key is at least 0x00800000 (v = -inf), so a table starts at 0
// and rows past P enter as 0.
constexpr int kRowBits = 16;                            // rows 0 .. 65535: P <= 65536
constexpr uint32_t kRowMask = (1u << kRowBits) - 1;

// The order images of the two bf16 values packed in p, each in its own half:
// a negative value of magnitude m becomes 0x8000 - m, any other v becomes
// v | 0x8000, so that the halves compare as unsigned integers as the values
// do, with -0 and +0 both 0x8000. (p ^ 0xFFFF) + 1 = 0x8000 - m on a negative
// half, and never carries into the next half.
__device__ __forceinline__ uint32_t order2(uint32_t p) {
  const uint32_t neg = (p >> 15) & 0x00010001u;
  return (p ^ (neg * 0x7FFFu | 0x80008000u)) + neg;
}
__device__ __forceinline__ float key_value(uint32_t key) {
  const uint32_t ord = key >> kRowBits;
  return __uint_as_float((ord >= 0x8000u ? ord ^ 0x8000u : (0x8000u - ord) | 0x8000u) << 16);
}
__device__ __forceinline__ int key_row(uint32_t key) { return static_cast<int>(kRowMask - (key & kRowMask)); }

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) { return *reinterpret_cast<const uint32_t*>(&v); }

// Fold a 64 x 128 accumulator's argmax candidates into `keys` (the 128
// channels' running keys in shared memory). Each element is rounded as the
// Pallas forward rounds it, v = round(round(acc) + b) with b the channel's
// bias (already a bf16 value), two columns at a time: one cvt packs the
// rounded pair, one bf16x2 add rounds the sum once, which equals rounding
// the f32 sum (an f32 sum of two bf16 values loses nothing that the bf16
// rounding keeps). Of a thread's two rows per column the larger key wins, so
// the upper row (g + 8) only if its v is strictly greater; rows at or past P
// (ok0: row g, ok1: row g + 8 below P) enter as key 0. row_bits is kRowMask
// - (row g's index in the cloud). The 32 winners go through `reduce_scatter`
// and an atomic max as `fold_keys` does.
__device__ __forceinline__ void fold_argmax(const float (&acc)[64], const float* b, bool ok0,
                                            bool ok1, uint32_t row_bits, uint32_t* keys,
                                            const Who& me) {
  const uint32_t v0 = ok0 ? 0xFFFF0000u : 0u, v1 = ok1 ? 0xFFFF0000u : 0u;
  const uint32_t r0 = ok0 ? row_bits : 0u, r1 = ok1 ? row_bits - 8 : 0u;
  uint32_t k[32];
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + 8 * jj + 2 * me.t));
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(bb.x, bb.y);
    // columns 8 jj + 2 t (low halves) and + 1 (high halves) of rows g and g + 8
    const uint32_t lo = order2(bf2_bits(__hadd2(__floats2bfloat162_rn(acc[4 * jj], acc[4 * jj + 1]), b2)));
    const uint32_t hi = order2(bf2_bits(__hadd2(__floats2bfloat162_rn(acc[4 * jj + 2], acc[4 * jj + 3]), b2)));
    k[2 * jj] = max(((lo << 16) & v0) | r0, ((hi << 16) & v1) | r1);
    k[2 * jj + 1] = max((lo & v0) | r0, (hi & v1) | r1);
  }
  fold_keys(k, keys, me);
}

// ---- the argmax keys of the K5 forward
// The same key, built where the ReLU comes last: v = relu(round(round(acc) +
// b)) is +0 or above, so the bf16 bits of v order it as an unsigned integer
// and no order image is needed; a negative value and -0 become +0 before
// keying, so every row at or below zero ties at +0 and the lowest of them
// wins, as in the Pallas forward `_fwd_kernel_1` (jnp.maximum(h + b, 0), then
// `_per_cloud_max_argmax`). The key is bits(v) << 16 | kRowMask - row; a row
// past P is key 0, below every candidate's (row 0's is at least kRowMask), so
// a table starts at 0. Decoded, the high half is v's f32 bits.

// Per 16-bit half of p: the bf16 value if it is +0 or above, else +0 (a
// signed 16-bit max with 0: a set sign bit, -0 included, reads as negative).
__device__ __forceinline__ uint32_t relu2(uint32_t p) {
  uint32_t r;
  asm("max.s16x2 %0, %1, %2;" : "=r"(r) : "r"(p), "r"(0u));
  return r;
}
// The keys of the low (column 2 t) and high (column 2 t + 1) halves of a
// ReLU'd pair p at a row whose kRowMask - row is r: the half's 16 bits above
// r's low 16 bits, one byte permute each.
__device__ __forceinline__ uint32_t relu_key_lo(uint32_t p, uint32_t r) { return __byte_perm(p, r, 0x1054); }
__device__ __forceinline__ uint32_t relu_key_hi(uint32_t p, uint32_t r) { return __byte_perm(p, r, 0x3254); }
__device__ __forceinline__ float relu_key_value(uint32_t key) { return __uint_as_float(key & ~kRowMask); }

// Fold a 64 x 128 accumulator's ReLU'd argmax candidates into a thread's
// running keys k[32] (k[2 jj + e]: column 8 jj + 2 t + e, as `rows_max`), in
// registers across a cloud: each element rounded as the Pallas forward
// rounds it, a row's column pair by one cvt, one bf16x2 add of the bias pair
// (b2[4 jj + t], bf16x2) and one `relu2`; then keyed and folded by unsigned
// max, so the order of tiles does not matter. row_bits is kRowMask - (row g's
// index in the cloud). With kMasked, rows at or past P (ok0: row g, ok1: row
// g + 8 below P) enter as key 0: a ring slot past P holds another cloud's rows.
template <bool kMasked>
__device__ __forceinline__ void relu_keys(const float (&acc)[64], const uint32_t* b2, bool ok0,
                                          bool ok1, uint32_t row_bits, uint32_t (&k)[32],
                                          const Who& me) {
  const uint32_t r0 = row_bits, r1 = row_bits - 8;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const uint32_t bb = b2[4 * jj + me.t];
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&bb);
    const uint32_t pg = relu2(bf2_bits(__hadd2(__floats2bfloat162_rn(acc[4 * jj], acc[4 * jj + 1]), b)));
    const uint32_t pg8 = relu2(bf2_bits(__hadd2(__floats2bfloat162_rn(acc[4 * jj + 2], acc[4 * jj + 3]), b)));
    uint32_t lo0 = relu_key_lo(pg, r0), hi0 = relu_key_hi(pg, r0);
    uint32_t lo1 = relu_key_lo(pg8, r1), hi1 = relu_key_hi(pg8, r1);
    if constexpr (kMasked) {
      lo0 = ok0 ? lo0 : 0u;
      hi0 = ok0 ? hi0 : 0u;
      lo1 = ok1 ? lo1 : 0u;
      hi1 = ok1 ? hi1 : 0u;
    }
    k[2 * jj] = max(k[2 * jj], max(lo0, lo1));
    k[2 * jj + 1] = max(k[2 * jj + 1], max(hi0, hi1));
  }
}

}  // namespace tail
}  // namespace catre
