// What the two `wgmma` encoder tails share: K1's bf16 build
// (encoder_tail_wgmma.cuh, the main conv3 -> conv4 -> max tail) and K2's
// (encoder_stn_tail_wgmma.cuh, the STN conv3 -> max tails). Both run blocks of
// two consumer warpgroups and one producer warpgroup that feeds x rows through
// a ring of shared-memory stages (K1 by 1-D bulk copies, K2 by 16-byte
// `cp.async`); both take the max over points on the bare f32 accumulator and
// round once per (cloud, channel).
// Here: a consumer thread's coordinates, the ring, the A registers of x rows,
// the order-preserving integer image of a float, and the max over the row
// lanes of a fragment with its fold into a table of running maxima.
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

// One step of the reduce-scatter below: lanes that differ in bit kHalf swap
// halves, each keeps the max of the half it owns.
template <int kHalf>
__device__ __forceinline__ void scatter_step(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, kHalf));
  }
}

// Fold the 32 column values of `rows_max` into the running maxima of their
// 128 channels (`keys`, order keys in shared memory): the eight row lanes
// (lane bits 4, 3, 2 = g bits 2, 1, 0) reduce and scatter in 28 shuffles,
// after which lane (g, t) holds values 4 g + i, i = 0 .. 3: columns 16 g + 8
// (i / 2) + 2 t + i % 2, each folded by an atomic max on its key. Exact and
// commutative: the table does not depend on the order of arrival. v is
// overwritten.
__device__ __forceinline__ void fold_keys(float (&v)[32], int* keys, const Who& me) {
  scatter_step<16>(v, me.lane);
  scatter_step<8>(v, me.lane);
  scatter_step<4>(v, me.lane);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    atomicMax(keys + 16 * me.g + 8 * (i / 2) + 2 * me.t + i % 2, order_key(v[i]));
}

}  // namespace tail
}  // namespace catre
