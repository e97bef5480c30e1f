// Sums across blocks without float atomics, shared by the backward kernels
// (rot_head_bwd.cu, encoder_epilogue_train.cu): `sum_rows` adds per-block
// partials in a fixed order, and `product_tn` is a split-K transposed product
// X^T Y over many rows (a weight gradient), each K range written by its own
// block and the ranges summed by `sum_rows`. Two launches on the same inputs
// give the same bits.
#pragma once

#include "common.cuh"

namespace catre {

// out[i] = sum over r of part[r * n + i], r = 0..rows-1 in order.
static __global__ void __launch_bounds__(kThreads)
sum_rows(const float* part, float* out, int rows, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += part[static_cast<size_t>(r) * n + i];
  out[i] = s;
}

// ---- gemm_tn: part[s][z] (M x N) = sum over k in range s of X[k, z*zoff + m] Y[k, z*zoff + n]
constexpr int kTnRows = 128;   // output rows (and columns) of a block; the accumulator is Acc<4>

template <typename T>
constexpr size_t tn_smem_bytes() {
  return 2 * sizeof(T) * kTnRows * kSliceLd;
}

// dst[c][kk] = src[(k0 + kk) * ld + c] for c < 128, kk < 64; zero where
// c >= cols or k0 + kk >= k_end. 16-byte loads along c, transposed stores;
// the lanes of a warp take 32 neighbouring kk, so each store touches 32
// different words of distinct banks.
template <typename T>
__device__ __forceinline__ void load_transposed(T* dst, const T* src, int ld, long long k0,
                                                long long k_end, int cols) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kTnRows / kVec;
  for (int i = threadIdx.x; i < kSliceK * kPerRow; i += kThreads) {
    const int kk = i % kSliceK, c = (i / kSliceK) * kVec;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (k0 + kk < k_end && c < cols)
      u = *reinterpret_cast<const uint4*>(src + (k0 + kk) * ld + c);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[(c + j) * kSliceLd + kk] = e[j];
  }
}

// acc += sA[128 x 64] @ sB[128 x 64]^T, both (row, k) with row stride
// kSliceLd: the fragment addressing of gemm_tile with both operands in
// shared memory.
__device__ __forceinline__ void mma_slice(Acc<4>& acc, const bf16* sA, const bf16* sB) {
  const Lane l;
  const bf16* a_row = sA + (l.wm * 64 + (l.lane % 16)) * kSliceLd + (l.lane / 16) * 8;
  const int m = l.lane / 8;
  const bf16* b_row = sB + (l.wn * 32 + (m / 2) * 8 + l.lane % 8) * kSliceLd + (m % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < kSliceK; kk += 16) {
    uint32_t a[4][4], bb[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], a_row + 16 * i * kSliceLd + kk);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t r[4];
      ldmatrix_x4(r, b_row + 16 * jj * kSliceLd + kk);
      bb[2 * jj][0] = r[0];
      bb[2 * jj][1] = r[1];
      bb[2 * jj + 1][0] = r[2];
      bb[2 * jj + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc.v[i][j], a[i], bb[j][0], bb[j][1]);
  }
}

__device__ __forceinline__ void mma_slice(Acc<4>& acc, const float* sA, const float* sB) {
  const Lane l;
  for (int k = 0; k < kSliceK; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc.v[i][j][e] = fmaf(sA[acc_row<4>(l, i, e) * kSliceLd + k],
                                sB[acc_col(l, j, e) * kSliceLd + k], acc.v[i][j][e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_tn(const T* X, int ldx, const T* Y, int ldy, int zoff, int M, int N, long long K,
        long long chunk, float* part) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + kTnRows * kSliceLd;
  const int mt = M / kTnRows;
  const int m0 = (blockIdx.x % mt) * kTnRows, n0 = (blockIdx.x / mt) * kTnRows;
  const int s = blockIdx.y, z = blockIdx.z;
  const long long k_begin = s * chunk, k_end = min(K, k_begin + chunk);
  const T* xs = X + static_cast<size_t>(z) * zoff + m0;
  const T* ys = Y + static_cast<size_t>(z) * zoff + n0;
  Acc<4> acc;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.0f;
  for (long long k0 = k_begin; k0 < k_end; k0 += kSliceK) {
    load_transposed(sA, xs, ldx, k0, k_end, M - m0);
    load_transposed(sB, ys, ldy, k0, k_end, N - n0);
    __syncthreads();
    mma_slice(acc, sA, sB);
    __syncthreads();
  }
  float* out = part + (static_cast<size_t>(s) * gridDim.z + z) * M * N;
  acc_for_each(acc, [&](int r, int c, float a) {
    if (n0 + c < N) out[static_cast<size_t>(m0 + r) * N + n0 + c] = a;
  });
}

// d_out[z] (M x N) of X^T Y over K rows: split-K partials in part, then their fixed-order sum.
template <typename T>
int product_tn(const T* X, int ldx, const T* Y, int ldy, int zoff, int Z, int M, int N, long long K,
               int splits, float* part, float* out, void* stream) {
  const long long chunk = (K + splits - 1) / splits;
  const int tiles = (M / kTnRows) * ((N + kTnRows - 1) / kTnRows);
  int err = launch(gemm_tn<T>, dim3(tiles, splits, Z), tn_smem_bytes<T>(), stream, X, ldx, Y, ldy,
                   zoff, M, N, K, chunk, part);
  if (err) return err;
  const int n = Z * M * N;
  return launch(sum_rows, (n + kThreads - 1) / kThreads, 0, stream, static_cast<const float*>(part),
                out, splits, n);
}

}  // namespace catre
