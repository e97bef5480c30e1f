// K6's backward, bf16 build for Hopper: the gradient of the main encoder tail
//   out[n, c] = max_p (relu(x[n, p] W3^T + b3) W4^T + b4)[c]
// given d_out (N, cout) f32 and the forward's idx (N, cout), the lowest point
// row that attains each max. It replaces the Pallas kernel
// catre_tpu/ops/pallas_encoder_epilogue_vjp.py::_bwd_kernel_2 (:121, called by
// _bwd_call_2 :243 under dense_relu_dense_max_t :294). The function, routed as
// in encoder_epilogue_train.cu's header: d4 = round(d_out); per critical row r
// (a row that some live channel's max sits on) g[r] = sum over {c: idx = r} of
// d4[c] W4[c], h3p[r] = x[r] W3^T + b3 in f32, d_h3[r] = round(g[r]) where
// h3p[r] > 0, else 0; dx[r] = d_h3[r] W3 (zero on every other row); dW3 =
// d_h3^T x, db3 = sum d_h3; dW4[c] = sum_n d4[n, c] round(relu(h3p[n,
// idx[n, c]])), db4 = sum_n d4. dx comes out in bf16, each element rounded
// once from its f32 sum. The f32 build stays in encoder_epilogue_train.cu.
//
// What bounds it on the card: operations on the critical rows (h3p, dx, dW3:
// three products of 2 x rows x cin x chid) and on the argmax rows (dW4: one),
// about 0.21 TFLOP at N = P = 1024 with about 520 critical rows a cloud, and
// dx's 0.27 GB in bf16. What the old body spent beyond that: a dense (N, P, chid)
// scratch of d_h3 (1 GiB, zero-filled, written, read whole by a split-K
// product), h3 recomputed for every argmax row, and every product on
// `mma.sync` with the weights streamed from L2 per tile. What bounds this
// design instead is building g: a chain of dependent loads per key (its
// channel, then its W4 row) and a branch per row, on the CUDA cores, about
// half of the cloud and dW3 passes (tools/probe_k6b.py --phases).
//
// The design: four passes, each over critical rows or argmax rows only, no
// buffer of N x P x chid, no float atomics, every sum in a fixed order.
//   - route (encoder_epilogue_train.cu::route_clouds): one block per cloud
//     sorts its live keys row * cout + c and writes the cloud's channels in
//     (row, channel) order with their d4, its segment starts and its critical
//     rows to a (N, route_stride) int32 buffer (`CloudRoute`). The passes
//     below copy a cloud's row into shared memory and never sort;
//   - cloud pass (dx): persistent blocks keep W3 (chid x cin) resident as
//     swizzled K-major panels. Per tile of 128 critical rows (64 a warpgroup)
//     the x rows are gathered by 16-byte `cp.async` into swizzled panels (so
//     neither `wgmma` nor the gather meets a bank conflict); per 128-column
//     chunk of the hidden layer each warp builds g for its own 16 rows into a
//     padded tile (f32 sums in key order from the W4 rows in L2, 16 in flight
//     a warp, rounded once) while `wgmma` computes h3p = x W3^T with both
//     operands in shared memory; the gate turns h3p and g into the A
//     registers of dx += d_h3 W3, which reads W3's panels MN-major (the
//     transpose-B flag, as K4 reads W1), stored as bf16 pairs. Rows that no
//     channel points at are written as zero, so each dx byte is written once;
//   - dW3 pass: a block owns (64-column hidden chunk, group of clouds) and
//     keeps that chunk's 64 rows of W3 and 64 columns of W4 (128 KB at cout =
//     1024) resident, so its g needs no device-memory traffic. Per tile it
//     gathers the x rows, recomputes its chunk of h3p and of g, gates d_h3 in
//     place in shared memory and adds d_h3^T x by `wgmma` with both operands
//     read MN-major from the tiles as they lie: each warpgroup's 64 x 64
//     accumulator stays in registers for the whole group. db3 is summed from
//     the same tile. That recompute (a third of the products, and g a second
//     time) is the price of having no scratch;
//   - dW4 pass: a block owns (128 channels, 128 hidden columns, group of
//     clouds), keeps W3's chunk resident and walks its clouds with the next
//     cloud's 128 argmax rows of x in flight (two tiles; their row numbers and
//     d4 are loaded a cloud earlier still): h3 = round(relu(x W3^T + b3)) by
//     `wgmma`, then d4 h3 is added into register accumulators laid out like
//     the product's. h3 never reaches device memory.
// Per-group partials of dW3, db3, dW4 and db4 are summed in order by
// gemm_tn.cuh::sum_rows.
#pragma once

#include "encoder_tail_common.cuh"

namespace catre {
namespace tailbwd {

constexpr int kTile = 128;                 // rows of a tile: 64 per warpgroup
constexpr int kChunk = 128;                // hidden columns a product covers
constexpr int kPanelBytes = kTile * wg::kRowBytes;   // a 64-column panel of 128 rows
constexpr int kGLd = kChunk + 8;           // row stride of the cloud pass's g tile, bf16
constexpr int kDw3Chunk = 64;              // hidden columns of a dW3 block: W4's columns of them
                                           // stay in its shared memory
constexpr int kAhead = 16;                 // W4 rows a warp has in flight while it builds g
static_assert(kThreads == 256, "two warpgroups a block");

#ifdef CATRE_K6B_SKIP_W4_GATHER
constexpr bool kSkipW4 = true;    // diagnostic build (tools/probe_k6b.py --skip-w4): g from a
                                  // constant in place of the W4 rows, no W4 traffic; wrong result
#else
constexpr bool kSkipW4 = false;
#endif

// Phases of a pass whose SM clocks the diagnostic build CATRE_K6B_PHASE_CLOCKS
// (tools/probe_k6b.py --phases) adds up: thread 0 of every block adds the
// clocks since its last mark to phase_clocks[pass][phase]. Ordinary builds
// compile the marks to nothing.
enum Phase { kRoute, kGaps, kGather, kBuildG, kWaitX, kIssue, kWaitMma, kGate, kTileEnd, kCloudEnd,
             kPhases };
#ifdef CATRE_K6B_PHASE_CLOCKS
__device__ unsigned long long phase_clocks[3][kPhases];
__device__ __forceinline__ long long sm_clock() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  return t;
}
struct PhaseClock {
  long long t;
  int pass;
  __device__ explicit PhaseClock(int p) : t(sm_clock()), pass(p) {}
  __device__ void mark(Phase k) {
    const long long now = sm_clock();
    if (threadIdx.x == 0) atomicAdd(&phase_clocks[pass][k], static_cast<unsigned long long>(now - t));
    t = now;
  }
};
#else
struct PhaseClock {
  __device__ explicit PhaseClock(int) {}
  __device__ void mark(Phase) {}
};
#endif

// ---- the routing buffer ---------------------------------------------------------
// One cloud's row, as route_clouds writes it: chan[j] the channel of the j-th
// live key in (row, channel) order and dval[j] its d4; seg[i] the first key
// of critical row i, seg[count] the number of live keys; rows[i] the point
// row of critical row i, ascending; count the critical rows. A pass copies a
// cloud's row into shared memory once (`stage_route`) and reads it there.
__host__ __device__ constexpr int route_stride(int cout) { return 4 * cout + 4; }

struct CloudRoute {
  const int* chan;
  const float* dval;
  const int* seg;
  const int* rows;
  int count;
  __device__ CloudRoute(const int* r, int cout) {
    chan = r;
    dval = reinterpret_cast<const float*>(r + cout);
    seg = r + 2 * cout;
    rows = r + 3 * cout + 1;
    count = r[4 * cout + 1];
  }
};

// Cloud n's routing row into `dst` (shared memory) by 16-byte cp.async. All
// threads call it; the caller commits, waits and meets the block.
__device__ __forceinline__ void stage_route(int* dst, const int* route, int n, int cout) {
  const int* src = route + static_cast<size_t>(n) * route_stride(cout);
  for (int i = threadIdx.x; i < route_stride(cout) / 4; i += kThreads)
    wg::cp_async16(dst + 4 * i, src + 4 * i);
}

// ---- shared memory ----------------------------------------------------------------
// From a 1024-byte boundary. Cloud pass: [W3 (cin / 64 panels of chid rows) |
// x tile (cin / 64 panels of kTile rows) | g tile (kTile x kGLd bf16) | the
// cloud's routing row | b3 (chid f32)]. dW3 pass: [W3's kDw3Chunk rows (cin /
// 64 panels) | x tile | d_h3 tile (1 panel) | W4[:, chunk] (cout x kDw3Chunk
// bf16) | routing row | db3 quarters (4 x kDw3Chunk f32) | b3's chunk]. dW4
// pass: [W3 chunk | two x tiles].
inline size_t cloud_smem_bytes(int cin, int chid, int cout) {
  return 1024 + static_cast<size_t>(cin / 64) * (chid + kTile) * wg::kRowBytes +
         sizeof(bf16) * kTile * kGLd + sizeof(int) * route_stride(cout) + sizeof(float) * chid;
}
inline size_t dw3_smem_bytes(int cin, int cout) {
  return 1024 + static_cast<size_t>(cin / 64) * (kDw3Chunk * wg::kRowBytes + kPanelBytes) +
         kPanelBytes + sizeof(bf16) * static_cast<size_t>(cout) * kDw3Chunk +
         sizeof(int) * route_stride(cout) + sizeof(float) * 5 * kDw3Chunk;
}
inline size_t dw4_smem_bytes(int cin) { return 1024 + static_cast<size_t>(3 * (cin / 64)) * kPanelBytes; }

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024 - (wg::smem_addr(raw) & 1023)) & 1023);
}

// ---- pieces -------------------------------------------------------------------------
template <int KX>
constexpr int kEach = kTile * 2 * KX / kThreads;     // 16-byte pieces of a tile a thread copies

// The row numbers of this thread's pieces (-1 past `valid`).
template <int KX>
__device__ __forceinline__ void row_ids(int (&src)[kEach<KX>], const int* rows, int valid) {
#pragma unroll
  for (int k = 0; k < kEach<KX>; ++k) {
    const int r = (threadIdx.x + k * kThreads) / (2 * KX);
    src[k] = r < valid ? rows[r] : -1;
  }
}

// The copies of this thread's pieces, rows from row_ids.
template <int KX>
__device__ __forceinline__ void copy_rows(unsigned char* xs, const bf16* xn,
                                          const int (&src)[kEach<KX>]) {
  constexpr int kPieces = 2 * KX;                     // 16-byte pieces of a row
#pragma unroll
  for (int k = 0; k < kEach<KX>; ++k) {
    const int i = threadIdx.x + k * kThreads, r = i / kPieces, c = i % kPieces;
    unsigned char* dst = xs + (c / 8) * kPanelBytes + r * wg::kRowBytes + (((c % 8) ^ (r & 7)) << 4);
    if (src[k] >= 0)
      wg::cp_async16(dst, xn + static_cast<size_t>(src[k]) * (16 * KX) + 8 * c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// Tile rows r < valid of xs = the x rows rows[r] of one cloud (xn, cin = 16
// KX), by 16-byte cp.async into KX / 4 swizzled K-major panels of kTile rows;
// rows past `valid` are zeroed. `rows` lies in shared or device memory; a
// thread reads all its row numbers before it issues its first copy (a copy
// waiting on its own index load would serialise them). All threads call it;
// the caller commits and waits.
template <int KX>
__device__ __forceinline__ void gather_rows(unsigned char* xs, const bf16* xn, const int* rows,
                                            int valid) {
  int src[kEach<KX>];
  row_ids<KX>(src, rows, valid);
  copy_rows<KX>(xs, xn, src);
}

// Starts acc (64 x 128) = the warpgroup's 64 rows of the tile xs (K-major
// panels of kTile rows) @ W[128 rows]^T, W's rows from `w` on in K-major
// panels `w_panel` bytes apart; K = 16 KX. Both operands in shared memory.
// Commits and returns at once: `finish` before acc is read.
template <int KX>
__device__ __forceinline__ void start_xw(float (&acc)[64], const unsigned char* xs, int wgi,
                                         const unsigned char* w, int w_panel) {
  wg::pin_new(acc);
  wg::wgmma_fence();
#pragma unroll
  for (int s = 0; s < KX; ++s) {
    const uint64_t a = wg::panel_desc(xs + (s / 4) * kPanelBytes + wgi * 64 * wg::kRowBytes) +
                       (s % 4) * wg::kKStepUnits;
    const uint64_t b = wg::panel_desc(w + (s / 4) * w_panel) + (s % 4) * wg::kKStepUnits;
    wg::wgmma_m64n128k16_ss(acc, a, b, s > 0);
  }
  wg::wgmma_commit();
  wg::pin(acc);
}

// Waits for every product this warpgroup started; acc is readable after it.
__device__ __forceinline__ void finish(float (&acc)[64]) {
  wg::wgmma_wait();
  wg::pin(acc);
}

// d (64 x 64) += A^T B over the kTile rows of a tile: A the 64 columns of
// panel `a`, B the 64 columns of panel `b`, both read MN-major (K runs down the
// panels' rows, 16 rows a k-step).
__device__ __forceinline__ void product_tt(float (&d)[32], const unsigned char* a,
                                           const unsigned char* b) {
  const uint64_t ad = wg::panel_desc(a), bd = wg::panel_desc(b);
  wg::pin(d);
  wg::wgmma_fence();
#pragma unroll
  for (int s = 0; s < kTile / 16; ++s)
    wg::wgmma_m64n64k16_ss<1, 1>(d, ad + s * wg::kKStepRowsUnits, bd + s * wg::kKStepRowsUnits, 1);
  wg::wgmma_commit();
  wg::wgmma_wait();
  wg::pin(d);
}

// g for this warp's 16 tile rows r0 .. r0 + 15 (critical rows t0 + r of the
// cloud, whose route `rt` lies in shared memory) and the hidden columns c0 ..
// c0 + 127: g[r] = round(sum over the keys of row t0 + r, in key order, of
// d4[c] W4[c]) with f32 sums; lane l owns the columns c0 + 4 l .. + 3. The
// warp walks its rows' keys kAhead at a time, all their W4 loads in flight
// together. store(r, lo, hi) receives row r's four rounded values as two bf16
// pairs; rows past the route's count get zeros.
template <typename Store>
__device__ __forceinline__ void build_g(const CloudRoute& rt, int t0, int r0, const bf16* w4,
                                        int chid, int c0, int lane, Store store) {
  const int i0 = t0 + r0, i1 = min(i0 + 16, rt.count);
  for (int r = max(i1 - t0, r0); r < r0 + 16; ++r) store(r, 0u, 0u);
  if (i0 >= i1) return;
  const int j_end = rt.seg[i1];
  int i = i0, next = rt.seg[i0 + 1];
  const bf16* wl = w4 + c0 + 4 * lane;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 1
  for (int j = rt.seg[i0]; j < j_end; j += kAhead) {
    uint2 wv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      wv[u] = make_uint2(0x3f803f80u, 0x3f803f80u);    // bf16 1.0 (the diagnostic's stand-in)
      if (!kSkipW4 && j + u < j_end)
        wv[u] = __ldg(reinterpret_cast<const uint2*>(wl + static_cast<size_t>(rt.chan[j + u]) * chid));
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (j + u < j_end) {
        if (j + u == next) {   // the key opens the next row: the row before is complete
          store(i - t0, wg::pack_a(a0, a1), wg::pack_a(a2, a3));
          a0 = a1 = a2 = a3 = 0.0f;
          ++i;
          next = rt.seg[i + 1];
        }
        const float dv = rt.dval[j + u];
        const float2 w01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv[u].x));
        const float2 w23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv[u].y));
        a0 = fmaf(dv, w01.x, a0);
        a1 = fmaf(dv, w01.y, a1);
        a2 = fmaf(dv, w23.x, a2);
        a3 = fmaf(dv, w23.y, a3);
      }
    }
  }
  store(i - t0, wg::pack_a(a0, a1), wg::pack_a(a2, a3));
}

// ---- cloud pass: dx -----------------------------------------------------------------------
// The A registers of dx += d_h3 W3 for one chunk: d_h3 = g where h3p = acc +
// b3 > 0, else 0, at the fragment positions of acc (k-step s takes the n-tiles
// 2 s and 2 s + 1); g from the padded tile, already rounded, so a pair of bf16
// is masked, not rounded again; b3's chunk from shared memory.
__device__ __forceinline__ void gate_a(const float (&acc)[64], uint32_t (&a)[8][4], const bf16* gs,
                                       const float* b3c, const tail::Who& me) {
  const uint32_t* g32 = reinterpret_cast<const uint32_t*>(gs);
  const int row = 64 * me.wgi + 16 * me.w + me.g;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int col = 8 * jj + 2 * me.t;
    const float2 b = *reinterpret_cast<const float2*>(b3c + col);     // shared memory
    const float b0 = b.x, b1 = b.y;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t gv = g32[((row + 8 * h) * kGLd + col) / 2];
      const uint32_t keep = (acc[4 * jj + 2 * h] + b0 > 0.0f ? 0x0000FFFFu : 0u) |
                            (acc[4 * jj + 2 * h + 1] + b1 > 0.0f ? 0xFFFF0000u : 0u);
      a[jj / 2][2 * (jj % 2) + h] = gv & keep;
    }
  }
}

// Starts dx (64 x 64 quarter) += a (the gated d_h3 of one chunk, 8 k-steps)
// @ W3[rows of the chunk, 64 columns], W3's panel read MN-major from `first`
// (row 128 c of panel q). Commits and returns: a and d stay in use until the
// warpgroup's next wait.
__device__ __forceinline__ void start_dx(float (&d)[32], uint32_t (&a)[8][4], const void* first,
                                         int accumulate) {
  const uint64_t desc = wg::panel_desc(first);
  if (accumulate) wg::pin(d);
  else wg::pin_new(d);
#pragma unroll
  for (int s = 0; s < 8; ++s) wg::pin(a[s]);
  wg::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s)
    wg::wgmma_m64n64k16<1>(d, a[s], desc + s * wg::kKStepRowsUnits, s > 0 ? 1 : accumulate);
  wg::wgmma_commit();
}

// Persistent blocks, clouds blockIdx.x, + gridDim.x, ...: dx of every row.
// Per chunk c the h3p product runs while the warps build g (for c = 0 the x
// gather lands meanwhile instead); the dx product is waited for at once (in
// flight under the next chunk's g, its registers spill).
template <int KX>
__global__ void __launch_bounds__(kThreads, 1)
cloud_pass(const bf16* x, const bf16* w3, const float* b3, const bf16* w4, const int* route,
           bf16* dx, int N, int P, int chid, int cout) {
  constexpr int kCin = 16 * KX, kXPanels = KX / 4, kNQ = kCin / 64;   // dx's 64-column quarters
  extern __shared__ unsigned char raw[];
  unsigned char* w3s = align1024(raw);
  unsigned char* xs = w3s + kXPanels * chid * wg::kRowBytes;
  bf16* gs = reinterpret_cast<bf16*>(xs + kXPanels * kPanelBytes);
  int* rs = reinterpret_cast<int*>(gs + kTile * kGLd);
  float* b3s = reinterpret_cast<float*>(rs + route_stride(cout));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const tail::Who me;
  const int w_panel = chid * wg::kRowBytes;
  wg::stage_weight(w3s, w3, kCin, chid, kCin, tid, kThreads);
  for (int c = tid; c < chid; c += kThreads) b3s[c] = b3[c];
  auto store_g = [&](int r, uint32_t lo, uint32_t hi) {
    *reinterpret_cast<uint2*>(gs + r * kGLd + 4 * lane) = make_uint2(lo, hi);
  };
  PhaseClock clk(0);

#pragma unroll 1
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    stage_route(rs, route, n, cout);
    wg::cp_async_commit();
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();     // and W3's panels, staged by ordinary stores
    __syncthreads();
    clk.mark(kRoute);
    const CloudRoute rt(rs, cout);
    const bf16* xn = x + static_cast<size_t>(n) * P * kCin;
    bf16* dxn = dx + static_cast<size_t>(n) * P * kCin;
    // rows that no channel points at: zero, a warp per gap between critical rows
    for (int i = warp; i <= rt.count; i += kThreads / 32) {
      const int lo = i > 0 ? rt.rows[i - 1] + 1 : 0, hi = i < rt.count ? rt.rows[i] : P;
      uint4* dst = reinterpret_cast<uint4*>(dxn + static_cast<size_t>(lo) * kCin);
      for (int e = lane; e < (hi - lo) * (kCin / 8); e += 32) dst[e] = make_uint4(0, 0, 0, 0);
    }
    clk.mark(kGaps);
#pragma unroll 1
    for (int t0 = 0; t0 < rt.count; t0 += kTile) {
      gather_rows<KX>(xs, xn, rt.rows + t0, min(kTile, rt.count - t0));
      wg::cp_async_commit();
      clk.mark(kGather);
      float dxa[kNQ][32];
      uint32_t a[8][4];
#pragma unroll 1
      for (int c = 0; c < chid / kChunk; ++c) {
        float acc[64];
        const unsigned char* w3c = w3s + c * kChunk * wg::kRowBytes;
        if (c == 0) {
          build_g(rt, t0, 16 * warp, w4, chid, 0, lane, store_g);
          clk.mark(kBuildG);
          wg::cp_async_wait<0>();
          wg::fence_proxy_async();
          __syncthreads();
          clk.mark(kWaitX);
          start_xw<KX>(acc, xs, me.wgi, w3c, w_panel);
          clk.mark(kIssue);
        } else {
          start_xw<KX>(acc, xs, me.wgi, w3c, w_panel);
          clk.mark(kIssue);
          build_g(rt, t0, 16 * warp, w4, chid, kChunk * c, lane, store_g);
          clk.mark(kBuildG);
        }
        __syncwarp();
        finish(acc);
        clk.mark(kWaitMma);
        gate_a(acc, a, gs, b3s + kChunk * c, me);
#pragma unroll
        for (int q = 0; q < kNQ; ++q) start_dx(dxa[q], a, w3c + q * w_panel, c > 0);
        wg::wgmma_wait();   // a and dxa stay out of the registers the next g needs
#pragma unroll
        for (int q = 0; q < kNQ; ++q) wg::pin(dxa[q]);
#pragma unroll
        for (int s = 0; s < 8; ++s) wg::pin(a[s]);
        __syncwarp();   // the warp's g rows are read before the next chunk rewrites them
        clk.mark(kGate);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = t0 + 64 * me.wgi + 16 * me.w + me.g + 8 * h;
        if (r < rt.count) {
          bf16* dst = dxn + static_cast<size_t>(rt.rows[r]) * kCin + 2 * me.t;
#pragma unroll
          for (int q = 0; q < kNQ; ++q)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)     // a bf16 pair, rounded once from the f32 sums
              *reinterpret_cast<uint32_t*>(dst + 64 * q + 8 * jj) =
                  wg::pack_a(dxa[q][4 * jj + 2 * h], dxa[q][4 * jj + 2 * h + 1]);
        }
      }
      __syncthreads();   // xs is read before the next tile's gather rewrites it
      clk.mark(kTileEnd);
    }
    __syncthreads();     // the route is read before the next cloud's is staged
    clk.mark(kCloudEnd);
  }
}

// ---- dW3 pass ------------------------------------------------------------------------------
// Byte address of element (r, col < 64) of a one-panel tile of kTile rows
// (swizzled, K-major).
__device__ __forceinline__ unsigned char* tile_at(unsigned char* t, int r, int col) {
  return t + r * wg::kRowBytes + (((col / 8) ^ (r & 7)) << 4) + (col % 8) * 2;
}

// Starts acc (64 x 64) = the warpgroup's 64 rows of the tile xs @ W3c^T, W3c
// the block's kDw3Chunk rows of W3 in K-major panels of kDw3Chunk rows; K =
// 16 KX. Both operands in shared memory; commits and returns.
template <int KX>
__device__ __forceinline__ void start_xw64(float (&acc)[32], const unsigned char* xs, int wgi,
                                           const unsigned char* w) {
  wg::pin_new(acc);
  wg::wgmma_fence();
#pragma unroll
  for (int s = 0; s < KX; ++s) {
    const uint64_t a = wg::panel_desc(xs + (s / 4) * kPanelBytes + wgi * 64 * wg::kRowBytes) +
                       (s % 4) * wg::kKStepUnits;
    const uint64_t b = wg::panel_desc(w + (s / 4) * kDw3Chunk * wg::kRowBytes) +
                       (s % 4) * wg::kKStepUnits;
    wg::wgmma_m64n64k16_ss<0, 0>(acc, a, b, s > 0);
  }
  wg::wgmma_commit();
  wg::pin(acc);
}

// g for this warp's 16 tile rows and the block's kDw3Chunk hidden columns, as
// build_g, from W4's columns resident in shared memory (w4s: cout rows of
// kDw3Chunk bf16; lane l owns the columns 2 l, 2 l + 1): no device-memory
// traffic. Rounded pairs go to the d_h3 tile; rows past the count get zeros.
__device__ __forceinline__ void build_g_resident(const CloudRoute& rt, int t0, int r0,
                                                 const bf16* w4s, unsigned char* ds, int lane) {
  const int i0 = t0 + r0, i1 = min(i0 + 16, rt.count);
  auto store = [&](int r, float a0, float a1) {
    *reinterpret_cast<uint32_t*>(tile_at(ds, r, 2 * lane)) = wg::pack_a(a0, a1);
  };
  for (int r = max(i1 - t0, r0); r < r0 + 16; ++r) store(r, 0.0f, 0.0f);
  if (i0 >= i1) return;
  const int j_end = rt.seg[i1];
  int i = i0, next = rt.seg[i0 + 1];
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
  for (int j = rt.seg[i0]; j < j_end; ++j) {
    if (j == next) {   // the key opens the next row: the row before is complete
      store(i - t0, a0, a1);
      a0 = a1 = 0.0f;
      ++i;
      next = rt.seg[i + 1];
    }
    const float dv = rt.dval[j];
    const float2 w = kSkipW4 ? make_float2(1.0f, 1.0f)
                             : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                   w4s + rt.chan[j] * kDw3Chunk + 2 * lane));
    a0 = fmaf(dv, w.x, a0);
    a1 = fmaf(dv, w.y, a1);
  }
  store(i - t0, a0, a1);
}

// d_h3 = g where acc + b3 > 0, else 0: the tile's bf16 pairs at acc's fragment
// positions masked in place (each pair belongs to one thread); b3's chunk from
// shared memory.
__device__ __forceinline__ void gate_in_place(const float (&acc)[32], unsigned char* ds,
                                              const float* b3c, const tail::Who& me) {
  const int row = 64 * me.wgi + 16 * me.w + me.g;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = 8 * jj + 2 * me.t;
    const float2 b = *reinterpret_cast<const float2*>(b3c + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t* p = reinterpret_cast<uint32_t*>(tile_at(ds, row + 8 * h, col));
      const uint32_t keep = (acc[4 * jj + 2 * h] + b.x > 0.0f ? 0x0000FFFFu : 0u) |
                            (acc[4 * jj + 2 * h + 1] + b.y > 0.0f ? 0xFFFF0000u : 0u);
      *p &= keep;
    }
  }
}

// Block (hidden chunk c0 = kDw3Chunk blockIdx.x, group blockIdx.y of
// per_group clouds): part_w3[group][c0 + m][k] = sum over the group's
// critical rows of d_h3[., c0 + m] x[., k]; part_b3[group][c0 + m] = sum of
// d_h3[., c0 + m]. Warpgroup wgi owns the input columns 64 wgi .. + 63 of the
// product (at cin = 64 warpgroup 1 has none). The x gather lands while the
// warps build g.
template <int KX>
__global__ void __launch_bounds__(kThreads, 1)
dw3_pass(const bf16* x, const bf16* w3, const float* b3, const bf16* w4, const int* route,
         float* part_w3, float* part_b3, int N, int P, int chid, int cout, int per_group) {
  constexpr int kCin = 16 * KX, kXPanels = KX / 4, kNQ = kCin / 64;
  extern __shared__ unsigned char raw[];
  unsigned char* w3s = align1024(raw);
  unsigned char* xs = w3s + kXPanels * kDw3Chunk * wg::kRowBytes;
  unsigned char* ds = xs + kXPanels * kPanelBytes;
  bf16* w4s = reinterpret_cast<bf16*>(ds + kPanelBytes);
  int* rs = reinterpret_cast<int*>(w4s + static_cast<size_t>(cout) * kDw3Chunk);
  float* dbq = reinterpret_cast<float*>(rs + route_stride(cout));
  float* b3c = dbq + 4 * kDw3Chunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const tail::Who me;
  const int c0 = kDw3Chunk * blockIdx.x, grp = blockIdx.y;
  const int n0 = grp * per_group, n1 = min(N, n0 + per_group);
  const int col = tid % kDw3Chunk, quarter = tid / kDw3Chunk;   // db3: a column, a quarter of the rows
  wg::stage_weight(w3s, w3 + static_cast<size_t>(c0) * kCin, kCin, kDw3Chunk, kCin, tid, kThreads);
  for (int i = tid; i < cout * (kDw3Chunk / 8); i += kThreads)   // W4[:, c0 : c0 + 64], 16 bytes a copy
    wg::cp_async16(w4s + 8 * i, w4 + static_cast<size_t>(i / (kDw3Chunk / 8)) * chid + c0 +
                                    8 * (i % (kDw3Chunk / 8)));
  if (tid < kDw3Chunk) b3c[tid] = b3[c0 + tid];
  PhaseClock clk(1);

  float acc3[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc3[i] = 0.0f;
  float db = 0.0f;
#pragma unroll 1
  for (int n = n0; n < n1; ++n) {
    stage_route(rs, route, n, cout);
    wg::cp_async_commit();
    wg::cp_async_wait<0>();      // and W4's columns
    wg::fence_proxy_async();     // and W3's rows, staged by ordinary stores
    __syncthreads();
    clk.mark(kRoute);
    const CloudRoute rt(rs, cout);
    const bf16* xn = x + static_cast<size_t>(n) * P * kCin;
#pragma unroll 1
    for (int t0 = 0; t0 < rt.count; t0 += kTile) {
      const int valid = min(kTile, rt.count - t0);
      gather_rows<KX>(xs, xn, rt.rows + t0, valid);
      wg::cp_async_commit();
      clk.mark(kGather);
      build_g_resident(rt, t0, 16 * warp, w4s, ds, lane);
      clk.mark(kBuildG);
      wg::cp_async_wait<0>();
      wg::fence_proxy_async();
      __syncthreads();
      clk.mark(kWaitX);
      float acc[32];
      start_xw64<KX>(acc, xs, me.wgi, w3s);
      wg::wgmma_wait();
      wg::pin(acc);
      clk.mark(kIssue);
      gate_in_place(acc, ds, b3c, me);
      wg::fence_proxy_async();
      __syncthreads();
      clk.mark(kGate);
      if (me.wgi < kNQ) product_tt(acc3, ds, xs + me.wgi * kPanelBytes);
      clk.mark(kWaitMma);
      for (int r = 32 * quarter; r < min(32 * quarter + 32, valid); ++r)
        db += __bfloat162float(*reinterpret_cast<const bf16*>(tile_at(ds, r, col)));
      clk.mark(kGaps);   // here: db3's column sums
      __syncthreads();   // the tiles are read before the next tile rewrites them
      clk.mark(kTileEnd);
    }
    __syncthreads();     // the route is read before the next cloud's is staged
    clk.mark(kCloudEnd);
  }
  // acc3[4 jj + e]: hidden row c0 + 16 w + g + 8 (e / 2), column 64 wgi + 8 jj + 2 t + e % 2
  if (me.wgi < kNQ) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = part_w3 + (static_cast<size_t>(grp) * chid + c0 + 16 * me.w + me.g + 8 * h) * kCin +
                   64 * me.wgi + 2 * me.t;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<float2*>(dst + 8 * jj) = make_float2(acc3[4 * jj + 2 * h], acc3[4 * jj + 2 * h + 1]);
    }
  }
  dbq[tid] = db;
  __syncthreads();
  if (tid < kDw3Chunk)
    part_b3[static_cast<size_t>(grp) * chid + c0 + tid] =
        ((dbq[tid] + dbq[kDw3Chunk + tid]) + dbq[2 * kDw3Chunk + tid]) + dbq[3 * kDw3Chunk + tid];
}

// ---- dW4 pass ------------------------------------------------------------------------------
// Block (channels ch0 .. ch0 + 127 and hidden chunk c0, from blockIdx.x; group
// blockIdx.y of per_group clouds): part_w4[group][ch0 + r][c0 + j] = sum_n
// d4[n, ch0 + r] round(relu(x[n, idx[n, ch0 + r]] W3[c0 + j] + b3[c0 + j]));
// part_b4[group][c] = sum_n d4[n, c] (from the c0 = 0 blocks).
template <int KX>
__global__ void __launch_bounds__(kThreads, 1)
dw4_pass(const bf16* x, const bf16* w3, const float* b3, const int* idx, const float* dout,
         float* part_w4, float* part_b4, int N, int P, int chid, int cout, int per_group) {
  constexpr int kCin = 16 * KX, kXPanels = KX / 4;
  extern __shared__ unsigned char raw[];
  unsigned char* w3s = align1024(raw);
  unsigned char* xs0 = w3s + kXPanels * kPanelBytes;
  const int tid = threadIdx.x;
  const tail::Who me;
  const int chunks = chid / kChunk;
  const int ch0 = kTile * (blockIdx.x / chunks), c0 = kChunk * (blockIdx.x % chunks);
  const int grp = blockIdx.y, n0 = grp * per_group, n1 = min(N, n0 + per_group);
  wg::stage_weight(w3s, w3 + static_cast<size_t>(c0) * kCin, kCin, kChunk, kCin, tid, kThreads);
  float bias[32];     // b3 at this thread's columns 8 jj + 2 t + e
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    bias[2 * jj] = __ldg(b3 + c0 + 8 * jj + 2 * me.t);
    bias[2 * jj + 1] = __ldg(b3 + c0 + 8 * jj + 2 * me.t + 1);
  }
  const int ch = ch0 + 64 * me.wgi + 16 * me.w + me.g;   // this thread's channels: ch, ch + 8
  float sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
  float db0 = 0.0f, db1 = 0.0f;
  auto tile = [&](int k) { return xs0 + (k & 1) * kXPanels * kPanelBytes; };
  auto d4 = [&](int n, int c) { return round_to<bf16>(__ldg(dout + static_cast<size_t>(n) * cout + c)); };
  PhaseClock clk(2);
  // the row numbers of the cloud to gather next, and the d4 of the cloud after
  // the current one, are loaded a cloud ahead of their use
  int src[kEach<KX>];
  float d0 = 0.0f, d1 = 0.0f, dn0 = 0.0f, dn1 = 0.0f;
  if (n0 < n1) {
    row_ids<KX>(src, idx + static_cast<size_t>(n0) * cout + ch0, kTile);
    copy_rows<KX>(tile(0), x + static_cast<size_t>(n0) * P * kCin, src);
    wg::cp_async_commit();
    if (n0 + 1 < n1) row_ids<KX>(src, idx + static_cast<size_t>(n0 + 1) * cout + ch0, kTile);
    d0 = d4(n0, ch);
    d1 = d4(n0, ch + 8);
  }
#pragma unroll 1
  for (int n = n0, k = 0; n < n1; ++n, ++k) {
    if (n + 1 < n1) {     // the next cloud's rows land while this one is multiplied
      copy_rows<KX>(tile(k + 1), x + static_cast<size_t>(n + 1) * P * kCin, src);
      wg::cp_async_commit();
      if (n + 2 < n1) row_ids<KX>(src, idx + static_cast<size_t>(n + 2) * cout + ch0, kTile);
      dn0 = d4(n + 1, ch);
      dn1 = d4(n + 1, ch + 8);
      clk.mark(kGather);
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    wg::fence_proxy_async();
    __syncthreads();
    clk.mark(kWaitX);
    float acc[64];
    start_xw<KX>(acc, tile(k), me.wgi, w3s, kPanelBytes);
    finish(acc);
    clk.mark(kWaitMma);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h3 = round_to<bf16>(fmaxf(acc[4 * jj + e] + bias[2 * jj + e % 2], 0.0f));
        sum[4 * jj + e] = fmaf(e < 2 ? d0 : d1, h3, sum[4 * jj + e]);
      }
    db0 += d0;
    db1 += d1;
    d0 = dn0;
    d1 = dn1;
    clk.mark(kGate);   // here: the epilogue
    __syncthreads();   // the tile is read before the gather two clouds on rewrites it
    clk.mark(kTileEnd);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* dst = part_w4 + (static_cast<size_t>(grp) * cout + ch + 8 * h) * chid + c0 + 2 * me.t;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      *reinterpret_cast<float2*>(dst + 8 * jj) = make_float2(sum[4 * jj + 2 * h], sum[4 * jj + 2 * h + 1]);
  }
  if (c0 == 0 && me.t == 0) {
    part_b4[static_cast<size_t>(grp) * cout + ch] = db0;
    part_b4[static_cast<size_t>(grp) * cout + ch + 8] = db1;
  }
}

}  // namespace tailbwd
}  // namespace catre
