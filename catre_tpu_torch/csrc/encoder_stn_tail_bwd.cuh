// K5's backward, bf16 build for Hopper: the gradient of the STN tails
//   out[n, c] = max_p relu(x[n, p] W^T + b)[c]
// given d_out (N, cout) f32 and the forward's idx (N, cout), the lowest point
// row that attains each max. It replaces the Pallas kernel
// catre_tpu/ops/pallas_encoder_epilogue_vjp.py::_bwd_kernel_1 (:77, called by
// _bwd_call_1 :192 under dense_relu_max_t :263). The function, routed as in
// encoder_epilogue_train.cu's header: d[n, c] = round(d_out[n, c]) where
// x[n, idx[n, c]] . W[c] + b[c] > 0 (f32 product, f32 unrounded bias), else 0;
// dx[n, p] = round(sum over the live channels c (d != 0) with idx = p of
// d W[c]), zero on every other row; dW[c] = sum_n d[n, c] x[n, idx[n, c]];
// db[c] = sum_n d[n, c]. dx comes out in bf16, rounded once from its f32 sum
// (round to nearest even, as the Pallas wrapper's cast to x's dtype rounds),
// dW and db in f32. The f32 build stays in encoder_epilogue_train.cu.
//
// What bounds it on the card: bytes. At N = P = 1024, cin = 128: dx written
// once in bf16 (268 MB), the argmax rows of x read once (about 540 of 1024 a
// cloud, 139 MB), d_out and idx: 0.124 ms at 3.35 TB/s. The operations (three
// length-cin products per (cloud, channel), 0.8 GFLOP f32) are a tenth of it.
// What stands in the way is latency, not traffic: a per-cloud block that
// gates, sorts and then stores runs every phase in lockstep with the others,
// and the stores wait on the loads.
//
// The design: three passes and the sums of the gate pass's partials, none
// waiting on a load it could have issued earlier, and dx written once, row
// after row, in bf16.
//   - gate pass: a block owns 64 channels and a group of clouds, two blocks an
//     SM; four threads own a channel, W's row of it in registers (a quarter
//     each), and walk the group's clouds with the argmax rows of the next
//     kStages - 1 clouds in flight (16-byte cp.async into a ring that only the
//     copying thread reads, so no barrier; each thread's row numbers are loaded
//     a cloud ahead of its copies). Per cloud: the gate's dot in f32 (four
//     chains a thread, a two-step butterfly across the four), d to an (N,
//     cout) buffer, and d x added into the threads' dW accumulators in
//     registers: per-group partials of dW and db, summed in order by
//     gemm_tn.cuh::sum_rows;
//   - routing pass: encoder_epilogue_train.cu::route_clouds, K6's, on the
//     gated d (its live test round(d) != 0 is d != 0): each cloud's live
//     channels in (row, channel) order, their d, segment starts and critical
//     rows (tailbwd::CloudRoute). Its buffer reuses the partials' storage;
//   - dx pass: persistent blocks of 1024 threads, each keeping one 64-column
//     chunk of W (cout x 128 bytes) resident in shared memory, walk the clouds
//     with the next cloud's routing row in flight. Per cloud a map of rows to
//     critical rows, then every row in order: eight lanes a row, a 16-byte
//     store each, the sum over the row's segment in key order (W from shared
//     memory) for a critical row, zeros for any other.
// Every sum has a fixed order and no float atomics: two launches give the
// same bits.
#pragma once

#include "encoder_tail_bwd_wgmma.cuh"

namespace catre {
namespace stnbwd {

constexpr int kQuad = 4;                      // gate-pass threads a channel
constexpr int kGateChannels = kThreads / kQuad;   // channels of a gate-pass block
constexpr int kStages = 6;                    // clouds a gate-pass thread has in its ring
constexpr int kCols = 64;                     // dx columns of a dx-pass block (128 bytes a row)
constexpr int kMapRows = 1024;                // point rows the dx pass maps at a time
constexpr int kDxThreads = 1024;              // threads of a dx-pass block: it takes 32 warps to keep
                                              // enough 16-byte stores in flight
constexpr unsigned kFull = 0xffffffffu;

#ifdef CATRE_K5B_GATE_ROW0
constexpr bool kRow0 = true;     // diagnostic build (tools/probe_k5b.py): the gate pass reads row 0
                                 // of each cloud for every channel, no scattered x traffic; wrong result
#else
constexpr bool kRow0 = false;
#endif
#ifdef CATRE_K5B_DX_ZEROS
constexpr bool kZeros = true;    // diagnostic build: the dx pass stores zeros on every row, no map,
                                 // no sums: the store stream alone; wrong result
#else
constexpr bool kZeros = false;
#endif

// Dynamic shared memory in bytes: the gate pass's ring (per stage and thread,
// KX / 2 16-byte pieces of x and d_out's 4 bytes), the dx pass's [W chunk (cout x
// kCols bf16) | two routing rows | map (kMapRows int)].
template <int KX>
constexpr size_t gate_smem_bytes() {
  return static_cast<size_t>(kStages) * kThreads * (16 * (KX / 2) + sizeof(float));
}
inline size_t dx_smem_bytes(int cout) {
  return static_cast<size_t>(cout) * kCols * sizeof(bf16) +
         2 * sizeof(int) * static_cast<size_t>(tailbwd::route_stride(cout)) + sizeof(int) * kMapRows;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(wg::smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// ---- gate pass ---------------------------------------------------------------------
// Block (channels c0 = kGateChannels blockIdx.x .., group blockIdx.y of
// per_group clouds); thread t owns channel c0 + t / kQuad and, with h = t %
// kQuad, the columns 8 (kQuad k + h) .. + 7 of piece k < KX / 2 (a channel's
// threads read 64 contiguous bytes a piece). d[n, c] = the gated, rounded
// cotangent; part_w[group][c][:] = sum over the group's clouds of d x[n,
// idx[n, c]] (clouds in order, f32 FMA); part_b[group][c] = sum of d.
template <int KX>
__global__ void __launch_bounds__(kThreads, 2)
gate_pass(const bf16* x, const bf16* w, const float* b, const int* idx, const float* dout, float* d,
          float* part_w, float* part_b, int N, int P, int cout, int per_group) {
  constexpr int kCin = 16 * KX, kPieces = KX / 2;
  extern __shared__ __align__(16) unsigned char stn_smem[];
  uint4* ring = reinterpret_cast<uint4*>(stn_smem);                            // [stage][piece][thread]
  float* dring = reinterpret_cast<float*>(ring + kStages * kPieces * kThreads);   // [stage][thread]
  const int tid = threadIdx.x, h = tid % kQuad;
  const int c = kGateChannels * blockIdx.x + tid / kQuad, grp = blockIdx.y;
  const int n0 = grp * per_group, n1 = min(N, n0 + per_group);
  uint4 wr[kPieces];
#pragma unroll
  for (int k = 0; k < kPieces; ++k)
    wr[k] = __ldg(reinterpret_cast<const uint4*>(w + static_cast<size_t>(c) * kCin + 8 * (kQuad * k + h)));
  const float bias = __ldg(b + c);
  auto row_of = [&](int n) { return kRow0 ? 0 : __ldg(idx + static_cast<size_t>(n) * cout + c); };
  // cloud n's row r of x and its d_out into stage s of this thread's ring
  auto issue = [&](int n, int r, int s) {
    const bf16* src = x + (static_cast<size_t>(n) * P + r) * kCin + 8 * h;
#pragma unroll
    for (int k = 0; k < kPieces; ++k)
      wg::cp_async16(ring + (s * kPieces + k) * kThreads + tid, src + 8 * kQuad * k);
    cp_async4(dring + s * kThreads + tid, dout + static_cast<size_t>(n) * cout + c);
  };
  float acc[8 * kPieces];
#pragma unroll
  for (int i = 0; i < 8 * kPieces; ++i) acc[i] = 0.0f;
  float db = 0.0f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (n0 + s < n1) issue(n0 + s, row_of(n0 + s), s);
    wg::cp_async_commit();
  }
  int r_next = n0 + kStages - 1 < n1 ? row_of(n0 + kStages - 1) : 0;   // the row of the next copy
#pragma unroll 1
  for (int n = n0, s = 0; n < n1; ++n, s = (s + 1) % kStages) {
    const int m = n + kStages - 1;
    if (m < n1) {
      issue(m, r_next, (s + kStages - 1) % kStages);
      if (m + 1 < n1) r_next = row_of(m + 1);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<kStages - 1>();     // cloud n's stage has landed
    uint4 xv[kPieces];
#pragma unroll
    for (int k = 0; k < kPieces; ++k) xv[k] = ring[(s * kPieces + k) * kThreads + tid];
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // four chains, not one: the dot's FMAs overlap
#pragma unroll
    for (int k = 0; k < kPieces; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = unpack2(word(xv[k], e)), wf = unpack2(word(wr[k], e));
        part[e] = fmaf(xf.y, wf.y, fmaf(xf.x, wf.x, part[e]));
      }
    float dot = (part[0] + part[1]) + (part[2] + part[3]);
    // the channel's quarters: a butterfly, so all kQuad threads hold the same bits
    dot += __shfl_xor_sync(kFull, dot, 1);
    dot += __shfl_xor_sync(kFull, dot, 2);
    const float dv = dot + bias > 0.0f ? round_to<bf16>(dring[s * kThreads + tid]) : 0.0f;
    if (h == 0) d[static_cast<size_t>(n) * cout + c] = dv;
    db += dv;
#pragma unroll
    for (int k = 0; k < kPieces; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = unpack2(word(xv[k], e));
        acc[8 * k + 2 * e] = fmaf(dv, xf.x, acc[8 * k + 2 * e]);
        acc[8 * k + 2 * e + 1] = fmaf(dv, xf.y, acc[8 * k + 2 * e + 1]);
      }
  }
  float* pw = part_w + (static_cast<size_t>(grp) * cout + c) * kCin;
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    float4* dst = reinterpret_cast<float4*>(pw + 8 * (kQuad * k + h));
    dst[0] = make_float4(acc[8 * k], acc[8 * k + 1], acc[8 * k + 2], acc[8 * k + 3]);
    dst[1] = make_float4(acc[8 * k + 4], acc[8 * k + 5], acc[8 * k + 6], acc[8 * k + 7]);
  }
  if (h == 0) part_b[static_cast<size_t>(grp) * cout + c] = db;
}

// ---- dx pass ---------------------------------------------------------------------
// Persistent blocks of kDxThreads: block i owns the columns kCols (i % groups)
// .. + kCols - 1 (groups = cin / kCols) of the clouds i / groups, + gridDim.x
// / groups, ...; gridDim.x is a multiple of groups. Writes every row of those
// clouds' dx columns once.
__global__ void __launch_bounds__(kDxThreads, 1)
dx_pass(const bf16* w, const int* route, bf16* dx, int N, int P, int cin, int cout) {
  extern __shared__ __align__(16) unsigned char stn_smem[];
  bf16* ws = reinterpret_cast<bf16*>(stn_smem);                                    // cout rows of kCols
  const int stride_r = tailbwd::route_stride(cout);
  int* rbuf = reinterpret_cast<int*>(ws + static_cast<size_t>(cout) * kCols);   // two routing rows
  int* row_map = rbuf + 2 * stride_r;       // row_map[r]: the critical row at point row t0 + r, or -1
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int groups = cin / kCols, q = blockIdx.x % groups, step = gridDim.x / groups;
  const int col0 = kCols * q;
  for (int i = tid; i < cout * (kCols / 8); i += kDxThreads)
    wg::cp_async16(ws + 8 * i, w + static_cast<size_t>(i / (kCols / 8)) * cin + col0 + 8 * (i % (kCols / 8)));
  // cloud n's routing row into `dst`, 16 bytes a copy
  auto stage = [&](int* dst, int n) {
    const int* src = route + static_cast<size_t>(n) * stride_r;
    for (int i = tid; i < stride_r / 4; i += kDxThreads) wg::cp_async16(dst + 4 * i, src + 4 * i);
  };
  int n = blockIdx.x / groups;
  if (n < N) stage(rbuf, n);
  wg::cp_async_commit();
  const int k = lane % 8, sub = lane / 8;   // this lane's 16-byte piece, and its row of the warp's four
#pragma unroll 1
  for (int it = 0; n < N; n += step, ++it) {
    const int* cur = rbuf + (it & 1) * stride_r;
    if (n + step < N) stage(rbuf + ((it + 1) & 1) * stride_r, n + step);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();     // this cloud's row (and, the first time, W's chunk) has landed
    __syncthreads();
    const tailbwd::CloudRoute rt(cur, cout);
    bf16* dxn = dx + static_cast<size_t>(n) * P * cin + col0 + 8 * k;
#pragma unroll 1
    for (int t0 = 0; t0 < P; t0 += kMapRows) {
      const int rows = min(kMapRows, P - t0);
      if (!kZeros) {
        for (int i = tid; i < rows; i += kDxThreads) row_map[i] = -1;
        __syncthreads();
        for (int i = tid; i < rt.count; i += kDxThreads) {
          const int r = rt.rows[i] - t0;
          if (r >= 0 && r < rows) row_map[r] = i;
        }
        __syncthreads();
      }
#pragma unroll 1
      for (int r = 4 * warp + sub; r < rows; r += 4 * (kDxThreads / 32)) {
        float a[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] = 0.0f;
        const int i = kZeros ? -1 : row_map[r];
        if (i >= 0) {
          const int j1 = rt.seg[i + 1];
#pragma unroll 2
          for (int j = rt.seg[i]; j < j1; ++j) {
            const float dv = rt.dval[j];
            const uint4 wv = *reinterpret_cast<const uint4*>(ws + rt.chan[j] * kCols + 8 * k);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 wf = unpack2(word(wv, e));
              a[2 * e] = fmaf(dv, wf.x, a[2 * e]);
              a[2 * e + 1] = fmaf(dv, wf.y, a[2 * e + 1]);
            }
          }
        }
        *reinterpret_cast<uint4*>(dxn + static_cast<size_t>(t0 + r) * cin) =
            make_uint4(wg::pack_a(a[0], a[1]), wg::pack_a(a[2], a[3]), wg::pack_a(a[4], a[5]),
                       wg::pack_a(a[6], a[7]));
      }
      __syncthreads();   // the map and the routing row are read before they are rewritten
    }
  }
  wg::cp_async_wait<0>();
}

}  // namespace stnbwd
}  // namespace catre
