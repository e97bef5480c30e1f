// Hopper building blocks for kernels whose products run on `wgmma` (sm_90a):
// shared-memory matrix descriptors, the warpgroup product with its fence /
// commit / wait, `mbarrier`s, the 1-D bulk copy, `cp.async` counted on an
// `mbarrier`, named barriers, register reallocation, and the
// accumulator-fragment bookkeeping that lets one product's result feed the
// next from registers. `common.cuh::gemm_tile`
// (mma.sync, 256-thread blocks) is a separate path and shares nothing with
// this header but the element type.
//
// Two shapes. D (64 x 128, f32) += A (64 x 16, bf16, registers) @ B^T, B =
// W[n0 : n0 + 128, k0 : k0 + 16] of a weight in PyTorch's (out, in) layout
// that sits in shared memory as K-panels (below): `product`. And D (64 x 64)
// += A @ B^T likewise, or A @ B with B = W[k0 : k0 + 16, n0 : n0 + 64], the
// same bytes read the other way (a backward product d_y W): `product_n64`.
// The 64 x 128 product also takes A from shared memory, a K-major panel like
// B's (`wgmma_m64n128k16_ss`), and `stmatrix_x4` writes such a panel from
// accumulator fragments. And D (64 x 64) += A @ B with both operands in
// shared memory, either one read MN-major (`wgmma_m64n64k16_ss`): a weight
// gradient d_y^T x over the rows of a tile, neither operand transposed in memory.
// A warpgroup is four consecutive warps, the first with warp index % 4 == 0.
//
// Fragments. Warp w of the warpgroup owns rows 16 w .. 16 w + 15; lane
// (g = lane / 4, t = lane % 4) holds
//   accumulator d[4 j + e]: row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2
//                           (j = 0 .. 15 for N = 128);
//   A of one k-step, four 32-bit registers of two bf16 (low half = lower
//   column): a[0] row g, columns 2 t, 2 t + 1;  a[1] row g + 8, same columns;
//            a[2] row g, columns 8 + 2 t, + 1;  a[3] row g + 8, same.
// So the A registers of k-step s are the accumulator n-tiles j = 2 s (a[0],
// a[1]) and j = 2 s + 1 (a[2], a[3]) of the product before, rounded and
// packed: `pack_a`. No trip through shared memory, no barrier.
//
// Weight panels. A (N x K) weight is stored as K / 64 panels; panel kp holds
// W[:, 64 kp : 64 kp + 64] as N rows of 128 bytes under the 128-byte swizzle
// (the 16-byte chunk index of a row is XORed with row % 8; panels start on
// 1024-byte boundaries). `stage_weight` writes that layout; `panel_desc`
// names a panel for wgmma (stride between 8-row groups 1024 bytes); a k-step
// inside a panel advances the descriptor's address by 32 bytes, 128 rows by
// 16384 bytes.
//
// The same panel read transposed (MN-major, the instruction's transpose-B
// flag): the product's N runs along a panel's 64 columns (one 128-byte row,
// the whole swizzle atom, so N = 64 is one panel and the leading offset is
// not used) and its K along the panel's rows, 8 rows (1024 bytes, the stride
// offset) a group. The descriptor has the same fields as the K-major one; a
// k-step of 16 rows advances its address by 2048 bytes, and 64 more columns
// are the next panel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace catre {
namespace wg {

constexpr int kRowBytes = 128;
constexpr int kHalfN = 128;                    // output columns of one product
constexpr int kKStepUnits = 32 >> 4;           // descriptor address units (16 bytes) per k-step
constexpr int kHalfNUnits = (kHalfN * kRowBytes) >> 4;
constexpr int kQuarterN = 64;                  // output columns of one `product_n64`
constexpr int kKStepRowsUnits = (16 * kRowBytes) >> 4;         // a k-step of 16 panel rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- weights in shared memory ---------------------------------------------------
// Copy W (n_rows x K bf16, row stride ldw elements, device memory) into
// `dst` as K / 64 swizzled panels of n_rows rows. All `n_threads` threads of
// the block call it with their index `tid`; 16 bytes a thread and step.
__device__ __forceinline__ void stage_weight(unsigned char* dst, const __nv_bfloat16* W, int ldw,
                                             int n_rows, int K, int tid, int n_threads) {
  const int chunks_per_row = K / 8;
  for (int i = tid; i < n_rows * chunks_per_row; i += n_threads) {
    const int n = i / chunks_per_row, c = i % chunks_per_row;
    const int panel = c / 8, chunk = c % 8;
    const uint4 val = *reinterpret_cast<const uint4*>(W + static_cast<size_t>(n) * ldw + c * 8);
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(panel) * n_rows * kRowBytes +
                              n * kRowBytes + ((chunk ^ (n & 7)) << 4)) = val;
  }
}

// Generic-proxy writes to shared memory (st.shared) before async-proxy reads
// (wgmma operands) or writes (bulk copies) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a panel under the 128-byte swizzle, from `panel` on: read
// K-major (N along the rows) or, 64 columns wide, MN-major (K along the rows).
__device__ __forceinline__ uint64_t panel_desc(const void* panel) {
  return static_cast<uint64_t>((smem_addr(panel) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |              // leading offset: unused for this layout
         (static_cast<uint64_t>(1024 >> 4) << 32) |      // 8-row groups are 1024 bytes apart
         (static_cast<uint64_t>(1) << 62);               // 128-byte swizzle
}

// ---- the product ------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most `kPending` committed groups are still running.
template <int kPending>
__device__ __forceinline__ void wgmma_wait_pending() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// The compiler does not know that wgmma reads and writes registers after the
// instruction has started: pin a fragment between its ordinary uses and the
// asynchronous ones.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d as written by nothing yet: defined for the compiler at no cost.
__device__ __forceinline__ void pin_new(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "=f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin_new(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "=f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x 128) = (accumulate ? d : 0) + A @ B^T with both operands in shared
// memory: A the 64 rows x 16 columns that `a_desc` names, B the 128 rows x 16
// columns of `b_desc`, both K-major panels (`panel_desc`). Asynchronous, as below.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a_desc,
                                                    uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d (64 x 64) = (accumulate ? d : 0) + A @ B with both operands in shared
// memory, each read MN-major when its flag is 1 (TA: A's 64 rows run along a
// panel's 128-byte row and its 16 columns down the panel's rows; TB: likewise
// B's 64 columns), K-major when it is 0. One 64-wide panel each, so the
// leading offset is not used. Asynchronous, as below.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a_desc,
                                                   uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 128) = (accumulate ? d : 0) + a (64 x 16, registers) @ B^T, B the 128
// rows x 16 columns that `b_desc` names. Asynchronous: fence before the first
// one after ordinary code wrote d or a, commit and wait before d is read.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
}

// d = A (64 x 16 KS, `KS` k-steps of registers) @ W[n0 : n0 + 128, :]^T for a
// weight staged as panels of `n_rows` rows; `half` = n0 / 128. d need not be
// initialised. Starts the products, commits, waits: on return d is readable
// and `a` may be rewritten.
template <int KS>
__device__ __forceinline__ void product(float (&d)[64], uint32_t (&a)[KS][4], const void* weight,
                                        int n_rows, int half) {
  const uint64_t desc = panel_desc(weight) + static_cast<uint64_t>(half) * kHalfNUnits;
  const uint64_t panel_units = static_cast<uint64_t>(n_rows * kRowBytes) >> 4;
  pin_new(d);
#pragma unroll
  for (int s = 0; s < KS; ++s) pin(a[s]);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s)
    wgmma_m64n128k16(d, a[s], desc + (s / 4) * panel_units + (s % 4) * kKStepUnits, s > 0);
  wgmma_commit();
  wgmma_wait();
  pin(d);
#pragma unroll
  for (int s = 0; s < KS; ++s) pin(a[s]);
}

// d (64 x 64) = (accumulate ? d : 0) + a (64 x 16, registers) @ B^T, B the 64
// rows x 16 columns that `b_desc` names (TRANS = 0), or a @ B, B the 16 rows
// x 64 columns from `b_desc` on (TRANS = 1). Asynchronous, as above.
template <int TRANS>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate), "n"(TRANS));
}

// d (64 x 64) = (accumulate ? d : 0) + A (64 x 16 KS) @ the weight bytes from
// `first` on, k-step s at `first` + s * `step_units` (16 bytes each):
//   TRANS = 0: A @ W[n0 : n0 + 64, k0 : k0 + 16 KS]^T inside one panel; `first`
//              is row n0 of the panel at column k0, the step kKStepUnits;
//   TRANS = 1: A @ W[k0 : k0 + 16 KS, 64 kp : 64 kp + 64]; `first` is row k0 of
//              panel kp, the step kKStepRowsUnits.
// Starts the products, commits, waits, as `product`.
template <int KS, int TRANS>
__device__ __forceinline__ void product_n64(float (&d)[32], uint32_t (&a)[KS][4], const void* first,
                                            int step_units, int accumulate) {
  const uint64_t desc = panel_desc(first);
  if (accumulate) pin(d);
  else pin_new(d);
#pragma unroll
  for (int s = 0; s < KS; ++s) pin(a[s]);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s)
    wgmma_m64n64k16<TRANS>(d, a[s], desc + static_cast<uint64_t>(s * step_units),
                           s > 0 ? 1 : accumulate);
  wgmma_commit();
  wgmma_wait();
  pin(d);
#pragma unroll
  for (int s = 0; s < KS; ++s) pin(a[s]);
}

// A registers from a row-major bf16 tile of 64 rows x 64 columns in shared
// memory (rows of 128 bytes, not swizzled: what a 1-D bulk copy lands):
// k-steps 0 .. 3 for this thread's warp `w` of the warpgroup. (The eight rows
// an 8 x 8 matrix reads lie on the same banks; four loads a tile.)
__device__ __forceinline__ void load_a_tile(uint32_t (&a)[4][4], const unsigned char* tile, int w,
                                            int lane) {
  const uint32_t base = smem_addr(tile) + (16 * w + lane % 16) * kRowBytes + (lane / 16) * 16;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[s][0]), "=r"(a[s][1]), "=r"(a[s][2]), "=r"(a[s][3])
                 : "r"(base + s * 32)
                 : "memory");
}

// Four 8 x 8 bf16 matrices from registers to shared memory, the inverse of
// ldmatrix: register i of lane (g, t) is row g, columns 2 t, 2 t + 1 of matrix
// i, and lane 8 i + r gives the address of row r of matrix i (16 bytes).
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// Two neighbouring f32 values as one A register (low half = lower column).
__device__ __forceinline__ uint32_t pack_a(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- mbarriers, bulk copy, named barriers, registers ------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}
// After the inits, before any thread uses a barrier (then a block-wide sync).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier has left the phase of parity `parity` (a new
// barrier is in phase 0: waiting on 1 returns at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from device memory to shared memory, both 16-byte
// aligned; completion is counted on `bar` (arrive_expect_tx the same bytes).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 16 bytes from device memory to shared memory by this thread (through L2,
// not L1), both 16-byte aligned; `cp_async_arrive` counts their completion.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// An arrival on `bar` once every cp.async this thread issued before has
// landed; it counts against the barrier's expected arrivals.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// The cp.async this thread issued since the last commit form one group;
// `cp_async_wait<N>` returns once at most N of its groups are still landing.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier `id` (1 .. 15; 0 is __syncthreads) over `n_threads` threads.
__device__ __forceinline__ void named_barrier(int id, int n_threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n_threads) : "memory");
}

// Register reallocation between the warpgroups of a block: every warp of a
// warpgroup executes it, inside one branch per role that never rejoins.
template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

}  // namespace wg
}  // namespace catre
