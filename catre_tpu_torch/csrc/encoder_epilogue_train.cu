// Differentiable PointNet encoder tails: kernels K5 and K6, forward with
// argmax and routed backward.
//
// Replaces the Pallas kernels of catre_tpu/ops/pallas_encoder_epilogue_vjp.py:
//   K5 dense_relu_max_t (:263): forward _fwd_kernel_1 (:67), backward
//      _bwd_kernel_1 (:77);  out[n, c] = max_p relu(x[n, p] W^T + b)[c]
//   K6 dense_relu_dense_max_t (:294): forward _fwd_kernel_2 (:107), backward
//      _bwd_kernel_2 (:121);  out = max_p (relu(x W3^T + b3) W4^T + b4)
// The forwards are K2/K1 with kIdx: they also return idx[n, c], the lowest
// point row that attains the max, so `out` is bit-equal to the inference
// kernels'. The f32 builds are encoder_epilogue.cuh's body; the bf16 builds
// are the inference kernels' `wgmma` bodies, K5's K2's persistent kernel
// (encoder_stn_tail_wgmma.cuh), K6's K1's (encoder_tail_wgmma.cuh), whose
// argmax folds round every element and keep the lowest tied row by an
// unsigned key per candidate.
//
// The backwards. The gradient of a max goes to one row per (cloud, channel),
// so d_h has cout non-zeros per cloud among P x cout entries. The Pallas
// kernels build that matrix densely from an iota compare and run dense
// products, because the TPU has no scatter: 825 GFLOP (K5) and 2.61 TFLOP
// (K6) per call at N = P = 1024. Here the same function is computed routed:
//   K5  d[n, c] = round_T(d_out[n, c]) where x[n, idx] . W[c] + b[c] > 0 (f32
//       product, f32 bias), else 0;  dx[n, p] = sum over {c: idx = p} d W[c];
//       dW[c] = sum_n d[n, c] x[n, idx[n, c]];  db[c] = sum_n d[n, c].
//   K6  d4 = round_T(d_out) (conv4 has no ReLU); with the critical rows of a
//       cloud (the rows some channel's max sits on):
//       g[r] = sum over {c: idx = r} d4[c] W4[c];  h3p[r] = x[r] W3^T + b3 (f32)
//       d_h3[r] = round_T(g[r]) where h3p[r] > 0, else 0;  dx[r] = d_h3[r] W3
//       dW3 = d_h3^T x;  db3 = sum d_h3;  db4 = sum_n d4
//       dW4[c] = sum_n d4[n, c] round_T(relu(h3p[n, idx[n, c]])).
// Rows of dx that no channel points at are written as zero.
//
// What bounds it on the card: bytes. K5 backward must write dx (N P cin, 268
// MB in bf16 at N = P = 1024) and read the argmax rows of x once (139 MB):
// 0.124 ms at 3.35 TB/s, against 0.4 GMAC of arithmetic. K6 backward does
// about 0.2 TFLOP on the critical rows (tensor cores) beside the same bytes.
//
// Design.
//   routing: one block per cloud orders its live channels (d != 0) by
//     (row, channel) and cuts the list into one segment per critical row (the
//     f32 bodies by a bitonic sort of the keys row * cout + c in shared
//     memory, the bf16 builds' routing pass `route_clouds` by a counting sort
//     by row). The segments give every sum over {c: idx = p} a fixed order: no
//     float atomics, two launches give the same bits.
//   K5 backward, f32 (the bf16 build is encoder_stn_tail_bwd.cuh: a gate and
//     dW pass, `route_clouds` on the gated d, a dx pass that writes bf16 rows
//     in order): (1) per cloud: gate (a warp per channel, dot of length cin),
//     route, zero dx, then a warp per critical row adds its segment's d W[c];
//     d goes to an (N, cout) scratch. (2) a warp per (channel, group of
//     clouds) gathers the argmax rows of x and adds them weighted by d:
//     per-group partials of dW and db, summed in order by sum_rows.
//   K6 backward, f32 (the bf16 build is encoder_tail_bwd_wgmma.cuh, after a
//     routing pass `route_clouds` that writes each cloud's sorted keys once):
//     (1) per cloud, tiles of TM critical rows: the rows of x are
//     gathered into shared memory, g is built per row from the W4 rows of its
//     segment, the W3 product (gemm_tile) gates it, the gated tile goes to the
//     dense (N, P, chid) scratch D and, multiplied by W3 (gemm_tile again),
//     to dx. (2) dW4: a block owns TM channels x 128 hidden columns and walks
//     a group of clouds; per cloud it gathers the TM argmax rows of x,
//     recomputes their h3 columns on the tensor cores and adds d4 h3 into
//     register accumulators laid out like the product's: h3 never reaches
//     device memory. Per-group partials, summed in order. (3) dW3 = D^T x is
//     the split-K product_tn over all N P rows (gemm_tn.cuh); D is zero on
//     the rows that are not critical.
// T = bf16 rounds d, d4, h3 and d_h3 to bf16 as the Pallas kernels do (f32
// accumulation); T = float is exact FMA, for tight checks on the card. Both
// bf16 backwards write dx in bf16, each element rounded once from its f32
// sum, as the Pallas wrappers cast the kernels' f32 dx to x's dtype.
#include "encoder_epilogue.cuh"
#include "encoder_stn_tail_bwd.cuh"
#include "encoder_stn_tail_wgmma.cuh"
#include "encoder_tail_bwd_wgmma.cuh"
#include "encoder_tail_wgmma.cuh"
#include "gemm_tn.cuh"

using namespace catre;

namespace {

constexpr int kNoKey = INT_MAX;   // key of a channel whose gradient is zero
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---- routing -------------------------------------------------------------------
// Ascending bitonic sort of keys[0:n2), n2 a power of two; all threads call it.
__device__ void sort_keys(int* keys, int n2) {
  for (int k = 2; k <= n2; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < n2; i += kThreads) {
        const int o = i ^ j;
        if (o > i) {
          const int a = keys[i], b = keys[o];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[o] = a;
          }
        }
      }
    }
  __syncthreads();
}

// keys sorted, live keys (row * cout + c) first: seg[i] = position of the
// first key of the i-th distinct row, seg[*n_rows] = number of live keys.
// All threads call it; warp 0 works.
__device__ void segment_rows(const int* keys, int n2, int cout, int* seg, int* n_rows) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0, live = 0;
    for (int j0 = 0; j0 < n2; j0 += 32) {
      const int j = j0 + lane;
      const int key = keys[j];
      const bool is_live = key != kNoKey;
      const bool head = is_live && (j == 0 || keys[j - 1] / cout != key / cout);
      const unsigned heads = __ballot_sync(kFull, head);
      if (head) seg[base + __popc(heads & ((1u << lane) - 1u))] = j;
      base += __popc(heads);
      live += __popc(__ballot_sync(kFull, is_live));
    }
    if (lane == 0) {
      seg[base] = live;
      *n_rows = base;
    }
  }
  __syncthreads();
}

// Shared memory of the per-cloud kernels: [keys (cout2) | seg (cout + 32) |
// d f32 (cout)], then what the kernel adds.
struct Route {
  int* keys;
  int* seg;
  float* d;
  __device__ Route(unsigned char* smem, int cout, int cout2) {
    keys = reinterpret_cast<int*>(smem);
    seg = keys + cout2;
    d = reinterpret_cast<float*>(seg + cout + 32);
  }
};

constexpr size_t route_bytes(int cout, int cout2) {
  return sizeof(int) * (static_cast<size_t>(cout2) + cout + 32 + cout);
}

// The bf16 backwards' routing pass (K6: on d4 = round(d_out); K5: on the
// gated d): one block per cloud writes its live keys (round(d) != 0) in (row,
// channel) order to the routing buffer as tailbwd::CloudRoute reads it:
// channels with their d, segment starts, critical rows, their count. A
// counting sort by row, kRouteRows rows at a time: a histogram of the live
// channels' rows (integer atomics: the counts do not depend on their order),
// one scan that gives each row its first key and each critical row its index,
// then warp 0 places the channels 32 at a time in channel order, ranking
// equal rows by __match_any_sync. The order is (row, channel) however the
// threads run. Shared memory: [counts, then cursors (kRouteRows) | each
// channel's row or -1 (cout) | its d (cout)].
constexpr int kRouteRows = 1024;

constexpr size_t route_smem_bytes(int cout) {
  return sizeof(int) * (static_cast<size_t>(kRouteRows) + 2 * cout);
}

__global__ void __launch_bounds__(kThreads)
route_clouds(const int* idx, const float* dout, int* route, int P, int cout) {
  extern __shared__ __align__(16) int route_smem[];
  int* hist = route_smem;
  int* row_of = hist + kRouteRows;
  float* d_of = reinterpret_cast<float*>(row_of + cout);
  __shared__ unsigned warp_sums[kWarps];
  __shared__ int base_keys, base_rows;      // keys and critical rows of the earlier tiles
  constexpr int kPer = kRouteRows / kThreads;
  const int n = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t nc = static_cast<size_t>(n) * cout;
  int* r = route + static_cast<size_t>(n) * tailbwd::route_stride(cout);
  for (int c = tid; c < cout; c += kThreads) {
    const float dv = round_to<bf16>(dout[nc + c]);
    row_of[c] = dv != 0.0f ? idx[nc + c] : -1;
    d_of[c] = dv;
  }
  if (tid == 0) base_keys = base_rows = 0;
#pragma unroll 1
  for (int t0 = 0; t0 < P; t0 += kRouteRows) {
    for (int i = tid; i < kRouteRows; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int c = tid; c < cout; c += kThreads) {
      const int row = row_of[c] - t0;
      if (row_of[c] >= 0 && row >= 0 && row < kRouteRows) atomicAdd(&hist[row], 1);
    }
    __syncthreads();
    // exclusive scan of (count << 16 | count > 0) over the tile's rows, kPer
    // consecutive rows a thread: each row's first key, each critical row's index
    unsigned pre[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const unsigned h = hist[tid * kPer + k];
      pre[k] = sum;
      sum += (h << 16) | (h > 0 ? 1u : 0u);
    }
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const unsigned y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    unsigned before = incl - sum;
    for (int w = 0; w < warp; ++w) before += warp_sums[w];
    const int bk = base_keys, br = base_rows;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int row = tid * kPer + k;
      const unsigned e = before + pre[k];
      const int first = bk + static_cast<int>(e >> 16);
      if (hist[row] > 0) {
        const int i = br + static_cast<int>(e & 0xFFFFu);
        r[2 * cout + i] = first;          // seg
        r[3 * cout + 1 + i] = t0 + row;   // rows
      }
      hist[row] = first;                  // from here on: the row's next key
    }
    __syncthreads();
    if (tid == kThreads - 1) {
      const unsigned total = before + sum;
      base_keys = bk + static_cast<int>(total >> 16);
      base_rows = br + static_cast<int>(total & 0xFFFFu);
    }
    if (warp == 0) {
      for (int c0 = 0; c0 < cout; c0 += 32) {
        const int c = c0 + lane;
        int row = c < cout ? row_of[c] - t0 : -1;
        if (c >= cout || row_of[c] < 0 || row < 0 || row >= kRouteRows) row = -1;
        const unsigned same = __match_any_sync(kFull, row);
        if (row >= 0) {
          const int j = hist[row] + __popc(same & ((1u << lane) - 1u));
          r[j] = c;
          r[cout + j] = __float_as_int(d_of[c]);
        }
        __syncwarp();
        if (row >= 0 && lane == __ffs(same) - 1) hist[row] += __popc(same);
        __syncwarp();
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    r[2 * cout + base_rows] = base_keys;   // seg[count]: the live keys
    r[4 * cout + 1] = base_rows;
  }
}

template <typename V>
__device__ __forceinline__ void zero_fill(V* dst, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += kThreads) dst[i] = V{};
}

// ---- K5 backward ------------------------------------------------------------------
// (1) one block per cloud: gate, route, dx. d_scratch (N, cout) receives d.
template <typename T>
__global__ void __launch_bounds__(kThreads)
relu_max_bwd_cloud(const T* x, const T* w, const float* b, const int* idx, const float* dout,
                   float* d_scratch, float* dx, int P, int cin, int cout, int cout2) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int n_rows;
  const Route q(smem, cout, cout2);
  const int n = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* xn = x + static_cast<size_t>(n) * P * cin;
  const size_t nc = static_cast<size_t>(n) * cout;

  // a warp takes cout / 8 neighbouring channels, 32 at a time: lane l loads
  // channel cb + l's row, the warp dots every channel's row with its weight
  const int per_warp = cout / kWarps, c_end = (warp + 1) * per_warp;
  for (int cb = warp * per_warp; cb < c_end; cb += 32) {
    const int c = cb + lane, cnt = min(32, c_end - cb);
    const int my_r = c < c_end ? idx[nc + c] : 0;
    float my_s = 0.0f;
#pragma unroll 4
    for (int k = 0; k < cnt; ++k) {
      const int r = __shfl_sync(kFull, my_r, k);
      const T* xr = xn + static_cast<size_t>(r) * cin;
      const T* wc = w + static_cast<size_t>(cb + k) * cin;
      float s = 0.0f;
      for (int i = 2 * lane; i < cin; i += 64) {
        const float2 xv = load2(xr + i), wv = load2(wc + i);
        s = fmaf(xv.x, wv.x, s);
        s = fmaf(xv.y, wv.y, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(kFull, s, off);
      if (lane == k) my_s = s;
    }
    if (c < c_end) {
      const float dv = my_s + b[c] > 0.0f ? round_to<T>(dout[nc + c]) : 0.0f;
      q.d[c] = dv;
      d_scratch[nc + c] = dv;
      q.keys[c] = dv != 0.0f ? my_r * cout + c : kNoKey;
    }
  }
  for (int c = cout + tid; c < cout2; c += kThreads) q.keys[c] = kNoKey;
  sort_keys(q.keys, cout2);
  segment_rows(q.keys, cout2, cout, q.seg, &n_rows);

  float* dxn = dx + static_cast<size_t>(n) * P * cin;
  zero_fill(reinterpret_cast<float4*>(dxn), static_cast<size_t>(P) * cin / 4);
  __syncthreads();
  // a warp per critical row; a lane owns columns k0 + 2 lane and the next
  for (int i = warp; i < n_rows; i += kWarps) {
    const int j0 = q.seg[i], j1 = q.seg[i + 1];
    const int row = q.keys[j0] / cout;
    for (int k0 = 2 * lane; k0 < cin; k0 += 64) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int j = j0; j < j1; ++j) {
        const int c = q.keys[j] % cout;
        const float dv = q.d[c];
        const float2 wv = load2(w + static_cast<size_t>(c) * cin + k0);
        a0 = fmaf(dv, wv.x, a0);
        a1 = fmaf(dv, wv.y, a1);
      }
      store2(dxn + static_cast<size_t>(row) * cin + k0, a0, a1);
    }
  }
}

// (2) a warp per channel and group of clouds [s * chunk, +chunk):
// part_w[s][c] = sum_n d[n, c] x[n, idx[n, c]], part_b[s][c] = sum_n d[n, c].
template <typename T>
__global__ void __launch_bounds__(kThreads)
relu_max_bwd_weight(const T* x, const int* idx, const float* d, float* part_w, float* part_b, int N,
                    int P, int cin, int cout, int chunk) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * kWarps + warp, s = blockIdx.y;
  const int n0 = s * chunk, n1 = min(N, n0 + chunk);
  float db = 0.0f;
  for (int k0 = 2 * lane; k0 < cin; k0 += 64) {
    float a0 = 0.0f, a1 = 0.0f;
    for (int nb = n0; nb < n1; nb += 32) {
      int my_r = 0;
      float my_d = 0.0f;
      if (nb + lane < n1) {
        my_r = idx[static_cast<size_t>(nb + lane) * cout + c];
        my_d = d[static_cast<size_t>(nb + lane) * cout + c];
      }
      const int cnt = min(32, n1 - nb);
#pragma unroll 4
      for (int k = 0; k < cnt; ++k) {
        const float dv = __shfl_sync(kFull, my_d, k);
        const int r = __shfl_sync(kFull, my_r, k);
        if (dv != 0.0f) {
          const float2 xv = load2(x + (static_cast<size_t>(nb + k) * P + r) * cin + k0);
          a0 = fmaf(dv, xv.x, a0);
          a1 = fmaf(dv, xv.y, a1);
        }
        if (k0 < 64) db += dv;
      }
    }
    store2(part_w + (static_cast<size_t>(s) * cout + c) * cin + k0, a0, a1);
  }
  if (lane == 0) part_b[static_cast<size_t>(s) * cout + c] = db;
}

// ---- K6 backward ------------------------------------------------------------------
// Shared memory of relu_dense_max_bwd_cloud: [Route | db3 f32 (chid) | rowof
// (TM) | weight stage | x tile (TM x cin+pad) | d_h3 tile (TM x chid+pad)].
template <typename T>
constexpr size_t cloud_smem_bytes(int cin, int chid, int cout, int cout2) {
  return route_bytes(cout, cout2) + sizeof(float) * chid + sizeof(int) * kTileM<T> +
         kStageBytes<T> + sizeof(T) * kTileM<T> * ((cin + kPad) + (chid + kPad));
}

// (1) one block per cloud: route, then per tile of critical rows d_h3 -> D
// (dh3) and dx; pdb3[n] = column sums of d_h3. w3t is W3^T (cin_pad, chid),
// zero rows past cin.
template <typename T>
__global__ void __launch_bounds__(kThreads)
relu_dense_max_bwd_cloud(const T* x, const T* w3, const float* b3, const T* w3t, const T* w4,
                         const int* idx, const float* dout, T* dh3, float* pdb3, float* dx, int P,
                         int cin, int cin_pad, int chid, int cout, int cout2) {
  constexpr int TM = kTileM<T>, MI = TM / 32, kVec = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int n_rows;
  const Route q(smem, cout, cout2);
  float* db3 = q.d + cout;
  int* rowof = reinterpret_cast<int*>(db3 + chid);
  T* stage = reinterpret_cast<T*>(rowof + TM);
  T* xs = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(stage) + kStageBytes<T>);
  const int ldx = cin + kPad, ldh = chid + kPad;
  T* hs = xs + TM * ldx;
  const int n = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* xn = x + static_cast<size_t>(n) * P * cin;
  const size_t nc = static_cast<size_t>(n) * cout;

  for (int c = tid; c < cout2; c += kThreads) {
    int key = kNoKey;
    if (c < cout) {
      const float dv = round_to<T>(dout[nc + c]);
      q.d[c] = dv;
      if (dv != 0.0f) key = idx[nc + c] * cout + c;
    }
    q.keys[c] = key;
  }
  for (int c = tid; c < chid; c += kThreads) db3[c] = 0.0f;
  sort_keys(q.keys, cout2);
  segment_rows(q.keys, cout2, cout, q.seg, &n_rows);

  float* dxn = dx + static_cast<size_t>(n) * P * cin;
  T* dhn = dh3 + static_cast<size_t>(n) * P * chid;
  zero_fill(reinterpret_cast<float4*>(dxn), static_cast<size_t>(P) * cin / 4);
  zero_fill(reinterpret_cast<uint4*>(dhn), static_cast<size_t>(P) * chid / kVec);
  __syncthreads();

  for (int t0 = 0; t0 < n_rows; t0 += TM) {
    const int rows = min(TM, n_rows - t0);
    if (tid < TM) rowof[tid] = tid < rows ? q.keys[q.seg[t0 + tid]] / cout : 0;
    __syncthreads();
    // the tile's rows of x
    const int per_row = cin / kVec;
    for (int i = tid; i < TM * per_row; i += kThreads) {
      const int r = i / per_row, v = i % per_row;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows)
        val = *reinterpret_cast<const uint4*>(xn + static_cast<size_t>(rowof[r]) * cin + v * kVec);
      *reinterpret_cast<uint4*>(xs + r * ldx + v * kVec) = val;
    }
    // g = sum over the row's segment of d4[c] W4[c], rounded: a warp per row,
    // a lane owns the column pairs k0 + 64 u + 2 lane, u < 4
    for (int r = warp; r < TM; r += kWarps) {
      const int j0 = r < rows ? q.seg[t0 + r] : 0, j1 = r < rows ? q.seg[t0 + r + 1] : 0;
      for (int k0 = 2 * lane; k0 < chid; k0 += 256) {
        float a[4][2] = {};
        for (int j = j0; j < j1; ++j) {
          const int c = q.keys[j] % cout;
          const float dv = q.d[c];
          const T* wr = w4 + static_cast<size_t>(c) * chid + k0;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (k0 + 64 * u < chid) {
              const float2 wv = load2(wr + 64 * u);
              a[u][0] = fmaf(dv, wv.x, a[u][0]);
              a[u][1] = fmaf(dv, wv.y, a[u][1]);
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (k0 + 64 * u < chid) store2(hs + r * ldh + k0 + 64 * u, a[u][0], a[u][1]);
      }
    }
    // the ReLU gate of conv3: h3p = x W3^T + b3 in f32, unrounded
    for (int h0 = 0; h0 < chid; h0 += kTileN) {
      Acc<MI> acc;
      gemm_tile(acc, xs, ldx, w3 + static_cast<size_t>(h0) * cin, cin, cin, stage);
      acc_for_each(acc, [&](int r, int c, float v) {
        if (!(v + b3[h0 + c] > 0.0f)) hs[r * ldh + h0 + c] = from_f32<T>(0.0f);
      });
    }
    __syncthreads();
    for (int c = tid; c < chid; c += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < rows; ++r) s += to_f32(hs[r * ldh + c]);
      db3[c] += s;
    }
    const int per_row_h = chid / kVec;
    for (int i = tid; i < rows * per_row_h; i += kThreads) {
      const int r = i / per_row_h, v = i % per_row_h;
      *reinterpret_cast<uint4*>(dhn + static_cast<size_t>(rowof[r]) * chid + v * kVec) =
          *reinterpret_cast<const uint4*>(hs + r * ldh + v * kVec);
    }
    // dx = d_h3 W3
    for (int c0 = 0; c0 < cin_pad; c0 += kTileN) {
      Acc<MI> acc;
      gemm_tile(acc, hs, ldh, w3t + static_cast<size_t>(c0) * chid, chid, chid, stage);
      acc_for_each(acc, [&](int r, int c, float v) {
        if (r < rows && c0 + c < cin) dxn[static_cast<size_t>(rowof[r]) * cin + c0 + c] = v;
      });
    }
    __syncthreads();   // rowof is read before the next tile overwrites it
  }
  __syncthreads();
  for (int c = tid; c < chid; c += kThreads) pdb3[static_cast<size_t>(n) * chid + c] = db3[c];
}

// Shared memory of relu_dense_max_bwd_w4: [d4 f32 (TM) | weight stage | x tile].
template <typename T>
constexpr size_t w4_smem_bytes(int cin) {
  return sizeof(float) * kTileM<T> + kStageBytes<T> + sizeof(T) * kTileM<T> * (cin + kPad);
}

// (2) block (channel tile c0, hidden chunk h0) x group s of clouds:
// part_w4[s][c0 + r][h0 + j] = sum_n d4[n, c0 + r] h3[n, idx[n, c0 + r]][h0 + j]
// with h3 = round_T(relu(x W3^T + b3)) recomputed per cloud on the TM gathered
// rows; part_b4[s][c] = sum_n d4[n, c] (from the h0 = 0 blocks).
template <typename T>
__global__ void __launch_bounds__(kThreads)
relu_dense_max_bwd_w4(const T* x, const T* w3, const float* b3, const int* idx, const float* dout,
                      float* part_w4, float* part_b4, int N, int P, int cin, int chid, int cout,
                      int chunk) {
  constexpr int TM = kTileM<T>, MI = TM / 32, kVec = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  float* ds = reinterpret_cast<float*>(smem);
  T* stage = reinterpret_cast<T*>(ds + TM);
  T* xs = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(stage) + kStageBytes<T>);
  const int ldx = cin + kPad, tid = threadIdx.x;
  const int h_chunks = chid / kTileN;
  const int c0 = (blockIdx.x / h_chunks) * TM, h0 = (blockIdx.x % h_chunks) * kTileN;
  const int s = blockIdx.y;
  const int n0 = s * chunk, n1 = min(N, n0 + chunk);
  const Lane l;
  Acc<MI> sum;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum.v[i][j][e] = 0.0f;
  float db = 0.0f;
  const int per_row = cin / kVec;
  for (int n = n0; n < n1; ++n) {
    const size_t nc = static_cast<size_t>(n) * cout + c0;
    if (tid < TM) {
      ds[tid] = round_to<T>(dout[nc + tid]);
      db += ds[tid];
    }
    for (int i = tid; i < TM * per_row; i += kThreads) {
      const int r = i / per_row, v = i % per_row;
      const size_t row = static_cast<size_t>(n) * P + idx[nc + r];
      *reinterpret_cast<uint4*>(xs + r * ldx + v * kVec) =
          *reinterpret_cast<const uint4*>(x + row * cin + v * kVec);
    }
    Acc<MI> acc;
    gemm_tile(acc, xs, ldx, w3 + static_cast<size_t>(h0) * cin, cin, cin, stage);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h3 = round_to<T>(fmaxf(acc.v[i][j][e] + b3[h0 + acc_col(l, j, e)], 0.0f));
          sum.v[i][j][e] = fmaf(ds[acc_row<MI>(l, i, e)], h3, sum.v[i][j][e]);
        }
    __syncthreads();   // ds and xs are read before the next cloud overwrites them
  }
  acc_store_rows(sum, part_w4 + (static_cast<size_t>(s) * cout + c0) * chid + h0, chid, TM,
                 [](int, int, float a) { return a; });
  if (h0 == 0 && tid < TM) part_b4[static_cast<size_t>(s) * cout + c0 + tid] = db;
}

// ---- launchers ------------------------------------------------------------------------
int sum_into(const float* part, float* out, int rows, int n, void* stream) {
  return launch(sum_rows, (n + kThreads - 1) / kThreads, 0, stream, part, out, rows, n);
}

// f32 (the tight checks' build): the per-cloud body and the weight pass above.
int run_relu_max_bwd_f32(const float* x, const float* w, const float* b, const int* idx,
                         const float* dout, float* d_scratch, float* part_w, float* part_b,
                         float* dx, float* dw, float* db, int n, int p, int cin, int cout, int cout2,
                         int groups, void* stream) {
  int err = launch(relu_max_bwd_cloud<float>, n, route_bytes(cout, cout2), stream, x, w, b, idx,
                   dout, d_scratch, dx, p, cin, cout, cout2);
  if (err) return err;
  const int chunk = (n + groups - 1) / groups;
  err = launch(relu_max_bwd_weight<float>, dim3(cout / kWarps, groups), 0, stream, x, idx,
               static_cast<const float*>(d_scratch), part_w, part_b, n, p, cin, cout, chunk);
  if (err) return err;
  err = sum_into(part_w, dw, groups, cout * cin, stream);
  if (err) return err;
  return sum_into(part_b, db, groups, cout, stream);
}

// bf16 (encoder_stn_tail_bwd.cuh): the gate pass, its partials summed in
// order, the routing pass on the gated d, the dx pass on `grid` persistent
// blocks. The routing rows may share storage with the partials: they are
// written only after the partials are summed.
template <int KX>
int run_relu_max_bwd_bf16(const bf16* x, const bf16* w, const float* b, const int* idx,
                          const float* dout, float* d, float* part_w, float* part_b, int* route,
                          bf16* dx, float* dw, float* db, int n, int p, int cout, int groups,
                          int grid, void* stream) {
  constexpr int kCin = 16 * KX;
  int err = launch(stnbwd::gate_pass<KX>, dim3(cout / stnbwd::kGateChannels, groups),
                   stnbwd::gate_smem_bytes<KX>(), stream, x, w, b, idx, dout, d, part_w, part_b, n,
                   p, cout, (n + groups - 1) / groups);
  if (err) return err;
  err = sum_into(part_w, dw, groups, cout * kCin, stream);
  if (err) return err;
  err = sum_into(part_b, db, groups, cout, stream);
  if (err) return err;
  err = launch(route_clouds, n, route_smem_bytes(cout), stream, idx, static_cast<const float*>(d),
               route, p, cout);
  if (err) return err;
  return launch_threads(stnbwd::dx_pass, grid, stnbwd::kDxThreads, stnbwd::dx_smem_bytes(cout),
                        stream, w, static_cast<const int*>(route), dx, n, p, kCin, cout);
}

// Pointer slots of catre_dense_relu_dense_max_train_bwd, in the order of
// catre_tpu_torch/ops/encoder_epilogue_train.py::K6_BWD_SLOTS.
// The f32 build takes no ROUTE, PART_W3, PART_B3 (null), the bf16 build no
// W3T, DH3, PDB3, GPART.
enum Slot {
  X, W3, B3, W3T, W4, IDX, DOUT, DH3, PDB3, PART_W4, PART_B4, GPART,
  DX, DW3, DB3, DW4, DB4, ROUTE, PART_W3, PART_B3,
  kSlots
};

template <typename T>
int run_relu_dense_max_bwd(void* const* ptr, int n, int p, int cin, int cin_pad, int chid, int cout,
                           int cout2, int groups, int splits, void* stream) {
  auto f = [&](Slot s) { return static_cast<float*>(ptr[s]); };
  auto tp = [&](Slot s) { return static_cast<T*>(ptr[s]); };
  const int* idx = static_cast<const int*>(ptr[IDX]);
  int err = launch(relu_dense_max_bwd_cloud<T>, n, cloud_smem_bytes<T>(cin, chid, cout, cout2),
                   stream, static_cast<const T*>(tp(X)), static_cast<const T*>(tp(W3)),
                   static_cast<const float*>(f(B3)), static_cast<const T*>(tp(W3T)),
                   static_cast<const T*>(tp(W4)), idx, static_cast<const float*>(f(DOUT)), tp(DH3),
                   f(PDB3), f(DX), p, cin, cin_pad, chid, cout, cout2);
  if (err) return err;
  const int chunk = (n + groups - 1) / groups;
  err = launch(relu_dense_max_bwd_w4<T>, dim3((cout / kTileM<T>) * (chid / kTileN), groups),
               w4_smem_bytes<T>(cin), stream, static_cast<const T*>(tp(X)),
               static_cast<const T*>(tp(W3)), static_cast<const float*>(f(B3)), idx,
               static_cast<const float*>(f(DOUT)), f(PART_W4), f(PART_B4), n, p, cin, chid, cout,
               chunk);
  if (err) return err;
  err = sum_into(f(PART_W4), f(DW4), groups, cout * chid, stream);
  if (err) return err;
  err = sum_into(f(PART_B4), f(DB4), groups, cout, stream);
  if (err) return err;
  err = sum_into(f(PDB3), f(DB3), n, chid, stream);
  if (err) return err;
  return product_tn<T>(tp(DH3), chid, tp(X), cin, 0, 1, chid, cin, static_cast<long long>(n) * p,
                       splits, f(GPART), f(DW3), stream);
}

// bf16: route, the three passes of encoder_tail_bwd_wgmma.cuh, then the
// partials summed in order: dW4 and db4 over `groups` groups of clouds, dW3
// and db3 over `splits`; the cloud pass runs `grid` persistent blocks.
template <int KX>
int run_relu_dense_max_bwd_wgmma(void* const* ptr, int n, int p, int chid, int cout,
                                 int groups, int splits, int grid, void* stream) {
  constexpr int kCin = 16 * KX;
  auto f = [&](Slot s) { return static_cast<float*>(ptr[s]); };
  const bf16* x = static_cast<const bf16*>(ptr[X]);
  const bf16* w3 = static_cast<const bf16*>(ptr[W3]);
  const bf16* w4 = static_cast<const bf16*>(ptr[W4]);
  const float* b3 = f(B3);
  const float* dout = f(DOUT);
  const int* idx = static_cast<const int*>(ptr[IDX]);
  int* route = static_cast<int*>(ptr[ROUTE]);
  int err = launch(route_clouds, n, route_smem_bytes(cout), stream, idx, dout, route, p, cout);
  if (err) return err;
  err = launch(tailbwd::cloud_pass<KX>, grid, tailbwd::cloud_smem_bytes(kCin, chid, cout), stream,
               x, w3, b3, w4, static_cast<const int*>(route), static_cast<bf16*>(ptr[DX]), n, p,
               chid, cout);
  if (err) return err;
  err = launch(tailbwd::dw3_pass<KX>, dim3(chid / tailbwd::kDw3Chunk, splits),
               tailbwd::dw3_smem_bytes(kCin, cout), stream, x, w3, b3, w4,
               static_cast<const int*>(route), f(PART_W3), f(PART_B3), n, p, chid, cout,
               (n + splits - 1) / splits);
  if (err) return err;
  err = launch(tailbwd::dw4_pass<KX>, dim3((cout / tailbwd::kTile) * (chid / tailbwd::kChunk), groups),
               tailbwd::dw4_smem_bytes(kCin), stream, x, w3, b3, idx, dout, f(PART_W4), f(PART_B4),
               n, p, chid, cout, (n + groups - 1) / groups);
  if (err) return err;
  err = sum_into(f(PART_W4), f(DW4), groups, cout * chid, stream);
  if (err) return err;
  err = sum_into(f(PART_B4), f(DB4), groups, cout, stream);
  if (err) return err;
  err = sum_into(f(PART_W3), f(DW3), splits, chid * kCin, stream);
  if (err) return err;
  return sum_into(f(PART_B3), f(DB3), splits, chid, stream);
}

}  // namespace

// K5 forward. x (n, p, cin) and w (cout, cin) in T = bf16 if `bf16` else f32;
// b (cout) f32 already rounded to T; out (n, cout) f32, idx (n, cout) i32.
// cin % 64 == 0, cout % 128 == 0. In bf16 (K2's kernel with kIdx) cin is 64
// or 128, x starts on a 16-byte boundary, 1 <= p <= 65536 (the argmax keys
// hold 16 bits of row) and `grid` is the number of persistent blocks
// (ops/encoder_epilogue.py::stn_tail_grid with catre_k5_fwd_chunks()); f32
// launches a block per cloud.
extern "C" int catre_dense_relu_max_train_fwd(const void* x, const void* w, const void* b,
                                              void* out, void* idx, int n, int p, int cin, int cout,
                                              int bf16, int grid, void* stream) {
  const MaxOut<true> o{static_cast<float*>(out), static_cast<int*>(idx)};
  if (bf16) return stn::run<stn::kChunks>(x, w, b, o, n, p, cin, cout, grid, stream);
  return enc::run_relu_max<true>(x, w, b, o, n, p, cin, cout, stream);
}

// What the bf16 K5 forward keeps per block: its 128-channel chunks and its
// dynamic shared memory in bytes at cin = 128.
extern "C" int catre_k5_fwd_chunks() { return stn::kChunks; }
extern "C" int catre_k5_fwd_smem() {
  return static_cast<int>(stn::smem_bytes<8, stn::kChunks, true>());
}

// K6 forward. As catre_dense_relu_dense_max (in bf16 the weights repacked,
// cin 64 or 128, chid at most 512), with idx (n, cout) i32; in bf16 1 <= p <=
// 65536 (the argmax keys hold 16 bits of row).
extern "C" int catre_dense_relu_dense_max_train_fwd(const void* x, const void* w3, const void* b3,
                                                    const void* w4, const void* b4, void* out,
                                                    void* idx, int n, int p, int cin, int chid,
                                                    int cout, int bf16, void* stream) {
  const MaxOut<true> o{static_cast<float*>(out), static_cast<int*>(idx)};
  if (bf16) return tail::run(x, w3, b3, w4, b4, o, n, p, cin, chid, cout, stream);
  return enc::run_relu_dense_max<true>(x, w3, b3, w4, b4, o, n, p, cin, chid, cout, stream);
}

// Dynamic shared memory of the bf16 K6 forward (K1's body) in bytes.
extern "C" int catre_tail_smem(int chid, int cout) {
  return static_cast<int>(tail::smem_bytes(chid, cout));
}

// K5 backward. x, w in T = bf16 if `bf16` else f32; b (cout) f32 unrounded;
// idx (n, cout) i32 from the forward; dout (n, cout) f32. Scratch: d_scratch
// (n, cout), part_w (groups, cout, cin), part_b (groups, cout), all f32; in
// bf16 also route (n, catre_k6_route_stride(cout)) i32, which may share
// storage with part_w and part_b (f32: null). Out: dx (n, p, cin) in T, dw
// (cout, cin), db (cout) f32. cout2 is cout rounded up to a power of two. In
// bf16 cin is 64 or 128, cout a multiple of 128 with catre_k5_bwd_smem(cin,
// cout, 1) within a block's shared memory, x starts on a 16-byte boundary, and
// `grid` (the dx pass's persistent blocks) is a multiple of cin / 64.
extern "C" int catre_dense_relu_max_train_bwd(const void* x, const void* w, const void* b,
                                              const void* idx, const void* dout, void* d_scratch,
                                              void* part_w, void* part_b, void* route, void* dx,
                                              void* dw, void* db, int n, int p, int cin, int cout,
                                              int cout2, int groups, int grid, int bf16,
                                              void* stream) {
  auto f = [](void* v) { return static_cast<float*>(v); };
  auto cf = [](const void* v) { return static_cast<const float*>(v); };
  const int* i = static_cast<const int*>(idx);
  if (!bf16)
    return run_relu_max_bwd_f32(cf(x), cf(w), cf(b), i, cf(dout), f(d_scratch), f(part_w),
                                f(part_b), f(dx), f(dw), f(db), n, p, cin, cout, cout2, groups,
                                stream);
  if ((cin != 64 && cin != 128) || cout <= 0 || cout % stnbwd::kGateChannels || n < 1 || p < 1 ||
      groups < 1 || grid < cin / stnbwd::kCols || grid % (cin / stnbwd::kCols) ||
      stnbwd::dx_smem_bytes(cout) > tail::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  auto args = [&](auto run) {
    return run(static_cast<const catre::bf16*>(x), static_cast<const catre::bf16*>(w), cf(b), i,
               cf(dout), f(d_scratch), f(part_w), f(part_b), static_cast<int*>(route),
               static_cast<catre::bf16*>(dx), f(dw), f(db), n, p, cout, groups, grid, stream);
  };
  return cin == 128 ? args(run_relu_max_bwd_bf16<8>) : args(run_relu_max_bwd_bf16<4>);
}

// Dynamic shared memory of the bf16 K5 backward's passes in bytes: 0 the
// gate pass, 1 the dx pass (W's 64-column chunk and two routing rows
// resident). The wrapper refuses widths at which 1 exceeds the limit.
extern "C" int catre_k5_bwd_smem(int cin, int cout, int pass) {
  if (pass == 1) return static_cast<int>(stnbwd::dx_smem_bytes(cout));
  return static_cast<int>(cin == 128 ? stnbwd::gate_smem_bytes<8>() : stnbwd::gate_smem_bytes<4>());
}

// K6 backward. ptr: kSlots device pointers in the order of Slot; x, w3, w3t,
// w4, dh3 and dx hold T, idx and route i32, every other array f32 (b3
// unrounded). groups: the partials of dW4 and db4; splits: those of dW3 (the
// f32 build's split-K ranges, the bf16 build's groups of clouds, which also
// split db3); grid: the bf16 cloud pass's persistent blocks (f32: unused). In
// bf16 cin is 64 or 128, chid and cout multiples of 128 with
// catre_k6_bwd_smem(cin, chid, cout, 0 and 1) within the shared memory of a
// block, and x starts on a 16-byte boundary.
extern "C" int catre_dense_relu_dense_max_train_bwd(void* const* ptr, int n, int p, int cin,
                                                    int cin_pad, int chid, int cout, int cout2,
                                                    int groups, int splits, int grid, int bf16,
                                                    void* stream) {
  if (!bf16)
    return run_relu_dense_max_bwd<float>(ptr, n, p, cin, cin_pad, chid, cout, cout2, groups,
                                         splits, stream);
  if ((cin != 64 && cin != 128) || chid <= 0 || chid % 128 || cout <= 0 || cout % 128 || n < 1 ||
      p < 1 || groups < 1 || splits < 1 || grid < 1 ||
      tailbwd::cloud_smem_bytes(cin, chid, cout) > tail::kSmemLimit ||
      tailbwd::dw3_smem_bytes(cin, cout) > tail::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  return cin == 128 ? run_relu_dense_max_bwd_wgmma<8>(ptr, n, p, chid, cout, groups, splits, grid,
                                                      stream)
                    : run_relu_dense_max_bwd_wgmma<4>(ptr, n, p, chid, cout, groups, splits, grid,
                                                      stream);
}

// Dynamic shared memory of the bf16 K6 backward's passes in bytes: 0 the
// cloud pass (W3 resident), 1 the dW3 pass (W4's chunk resident), 2 the dW4
// pass. The wrapper refuses widths at which 0 or 1 exceeds the limit.
extern "C" int catre_k6_bwd_smem(int cin, int chid, int cout, int pass) {
  return static_cast<int>(pass == 0   ? tailbwd::cloud_smem_bytes(cin, chid, cout)
                          : pass == 1 ? tailbwd::dw3_smem_bytes(cin, cout)
                                      : tailbwd::dw4_smem_bytes(cin));
}

extern "C" int catre_dense_relu_dense_max_train_bwd_slots() { return kSlots; }

// Ints of one cloud's row of the bf16 K6 backward's routing buffer.
extern "C" int catre_k6_route_stride(int cout) { return tailbwd::route_stride(cout); }

#ifdef CATRE_K6B_PHASE_CLOCKS
// Diagnostic build only: the clocks the bf16 K6 backward's passes added up
// since the last call, (3 passes x kPhases) into `out`; then zeroes them.
extern "C" int catre_k6b_phase_clocks(unsigned long long* out) {
  constexpr size_t kBytes = sizeof(unsigned long long) * 3 * tailbwd::kPhases;
  cudaError_t err = cudaMemcpyFromSymbol(out, tailbwd::phase_clocks, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zeros[3 * tailbwd::kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(tailbwd::phase_clocks, zeros, kBytes));
}
#endif
