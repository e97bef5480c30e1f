// Shared device helpers for the catre_tpu_torch kernels (sm_90a).
//
// Every kernel here runs blocks of kThreads = 256 threads (8 warps) and
// computes its products with `gemm_tile`: a tile of TM x 128 f32 accumulators
// = A (TM x K, shared memory, row-major) @ W^T, where W is a weight in
// PyTorch's (out, in) layout in device memory (it stays in L2: the largest is
// 512 x 1024 bf16 = 1 MB). The accumulators stay in registers; the kernels'
// epilogues read them through `acc_for_each` and `acc_col_reduce`. Two
// element types:
//   - bf16 (production): tensor cores through mma.sync.m16n8k16 with f32
//     accumulation, operands loaded by ldmatrix. The weight is staged through
//     shared memory in 64-deep slices with cp.async, double buffered, so the
//     next slice is in flight while the current one is multiplied. TM = 128;
//   - float (checks): plain FMA on the CUDA cores, exact f32, so that the card
//     can hold a kernel tightly against its f32 PyTorch twin. It computes the
//     same accumulator elements in each thread as the bf16 path, so both share
//     every epilogue. TM = 64 (its tiles take twice the bytes).
// Rounding to the compute dtype happens only where an epilogue asks
// (`round_to`), at the points where flax `Dense(dtype=...)` rounds.
// Shared-memory row strides are padded by kPad elements so that the rows an
// ldmatrix reads fall on distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace catre {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTileN = 128;   // columns of every gemm_tile (channels per chunk)
constexpr int kPad = 8;       // row padding of shared tiles, in elements
constexpr int kSliceK = 64;   // depth of one staged weight slice
constexpr int kSliceLd = kSliceK + kPad;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;
// rows of every gemm_tile (points per tile)
template <typename T>
constexpr int kTileM = kIsBf16<T> ? 128 : 64;
// shared memory of the staged weight slices (the f32 path reads W directly)
template <typename T>
constexpr size_t kStageBytes = kIsBf16<T> ? 2 * kTileN * kSliceLd * sizeof(bf16) : 0;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// Round an f32 value to T and back (identity for float).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Copy `rows` rows of `cols` elements (contiguous in device memory) into a
// `tile_rows`-row shared tile of row stride `ld`; rows past `rows` are zeroed.
// cols * sizeof(T) is a multiple of 16: the copy moves 16 bytes a thread.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int rows, int tile_rows,
                                          int cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = cols / kVec;
  for (int i = threadIdx.x; i < tile_rows * per_row; i += kThreads) {
    const int r = i / per_row, v = i % per_row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * cols + v * kVec);
    *reinterpret_cast<uint4*>(dst + r * ld + v * kVec) = val;
  }
}

// ---- accumulator layout ----------------------------------------------------
// The 8 warps form a 2 x 4 grid over the TM x 128 tile: warp (wm, wn) owns rows
// [wm * TM/2, +TM/2) and columns [wn * 32, +32), as MI = TM/32 m16 tiles by 4
// n8 tiles. Lane (g = lane / 4, t = lane % 4) holds element e of tile (i, j)
// at row wm*TM/2 + 16 i + g + 8 (e / 2) and column wn*32 + 8 j + 2 t + e % 2:
// the f32 accumulator layout of mma.m16n8k16 in the PTX ISA.
template <int MI>
struct Acc {
  float v[MI][4][4];
};

struct Lane {
  int wm, wn, g, t, lane;
  __device__ Lane() {
    const int warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    wm = warp / 4;
    wn = warp % 4;
    g = lane / 4;
    t = lane % 4;
  }
};

template <int MI>
__device__ __forceinline__ int acc_row(const Lane& l, int i, int e) {
  return l.wm * 16 * MI + 16 * i + l.g + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(const Lane& l, int j, int e) {
  return l.wn * 32 + 8 * j + 2 * l.t + (e & 1);
}

// ---- tensor-core primitives --------------------------------------------------
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issue the cp.async copies of W[0:128, k0:k0+64] into a staged slice.
__device__ __forceinline__ void stage_slice(bf16* dst, const bf16* W, int ldw, int k0) {
  constexpr int kPieces = kSliceK / 8;   // 16-byte pieces per row
  for (int i = threadIdx.x; i < kTileN * kPieces; i += kThreads) {
    const int n = i / kPieces, p = i % kPieces;
    __pipeline_memcpy_async(dst + n * kSliceLd + p * 8, W + static_cast<size_t>(n) * ldw + k0 + p * 8, 16);
  }
  __pipeline_commit();
}

// acc = A[TM x K] (row stride lda) @ W[128 x K]^T (row stride ldw). K is a
// multiple of 64; lda and ldw are multiples of 8. All 256 threads call it. A
// barrier precedes the first read of A (the caller may write A right up to
// the call) and one ends it (the stage buffer is free on return).
template <int MI>
__device__ __forceinline__ void gemm_tile(Acc<MI>& acc, const bf16* A, int lda, const bf16* W,
                                          int ldw, int K, bf16* stage) {
  const Lane l;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.0f;
  // ldmatrix row addresses: A rows of this warp (lanes 0-15 at k, 16-31 at k+8);
  // W rows n (lanes 8m..8m+7 give matrix m: n-half m/2, k-half m%2)
  const bf16* a_row = A + (l.wm * 16 * MI + (l.lane % 16)) * lda + (l.lane / 16) * 8;
  const int m = l.lane / 8;
  const int b_off = (l.wn * 32 + (m / 2) * 8 + l.lane % 8) * kSliceLd + (m % 2) * 8;
  const int n_slices = K / kSliceK;
  stage_slice(stage, W, ldw, 0);
  for (int s = 0; s < n_slices; ++s) {
    if (s + 1 < n_slices) {
      stage_slice(stage + ((s + 1) & 1) * kTileN * kSliceLd, W, ldw, (s + 1) * kSliceK);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const bf16* ws = stage + (s & 1) * kTileN * kSliceLd + b_off;
#pragma unroll
    for (int kk = 0; kk < kSliceK; kk += 16) {
      uint32_t a[MI][4], b[4][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldmatrix_x4(a[i], a_row + 16 * i * lda + s * kSliceK + kk);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, ws + 16 * jj * kSliceLd + kk);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc.v[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();   // slice s is read before stage s + 2 overwrites it
  }
}

template <int MI>
__device__ __forceinline__ void gemm_tile(Acc<MI>& acc, const float* A, int lda, const float* W,
                                          int ldw, int K, float* /*stage: unused*/) {
  const Lane l;
  __syncthreads();
  int rows[MI][2], cols[4][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) rows[i][h] = acc_row<MI>(l, i, 2 * h) * lda;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) cols[j][e] = acc_col(l, j, e) * ldw;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.0f;
  for (int k = 0; k < K; ++k) {
    float a[MI][2], b[4][2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) a[i][h] = A[rows[i][h] + k];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) b[j][e] = __ldg(W + cols[j][e] + k);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc.v[i][j][e] = fmaf(a[i][e >> 1], b[j][e & 1], acc.v[i][j][e]);
  }
  __syncthreads();
}

// ---- epilogues -----------------------------------------------------------------
// f(row, col, value) for every accumulator element this thread holds.
template <int MI, typename F>
__device__ __forceinline__ void acc_for_each(const Acc<MI>& acc, F f) {
  const Lane l;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f(acc_row<MI>(l, i, e), acc_col(l, j, e), acc.v[i][j][e]);
}

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct AddOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// Column reduction of value(row, col, acc) with `op` over each warp row's
// rows: red[col] holds warp row 0's result, red[128 + col] warp row 1's.
// `value` returns op's identity for a row to skip. The order is fixed, so the
// result is deterministic. The caller synchronises before reading red.
template <int MI, typename Op, typename F>
__device__ __forceinline__ void acc_col_reduce(const Acc<MI>& acc, Op op, F value, float* red) {
  const Lane l;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = acc_col(l, j, e);
      float x = value(acc_row<MI>(l, 0, 0), c, acc.v[0][j][e]);
      x = op(x, value(acc_row<MI>(l, 0, 2), c, acc.v[0][j][2 + e]));
#pragma unroll
      for (int i = 1; i < MI; ++i) {
        x = op(x, value(acc_row<MI>(l, i, 0), c, acc.v[i][j][e]));
        x = op(x, value(acc_row<MI>(l, i, 2), c, acc.v[i][j][2 + e]));
      }
#pragma unroll
      for (int off = 4; off < 32; off *= 2) x = op(x, __shfl_xor_sync(0xffffffffu, x, off));
      if (l.g == 0) red[l.wm * kTileN + c] = x;
    }
}

// Ask for more than 48 KB of dynamic shared memory, then launch; returns the
// first CUDA error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int grid, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace catre
