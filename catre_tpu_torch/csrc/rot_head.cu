// Fused rotation heads (both per-axis heads of ConvOutPerRotHead) per object:
// kernels K3, K7 and K8.
//
// Replaces three Pallas kernels:
//   K3 catre_tpu/ops/pallas_heads.py::fused_conv_per_rot_head (:276) on its
//      group=1 path (body _kernel :132);
//   K7 the same with group > 1 (body _kernel_grouped :183, call :358);
//   K8 catre_tpu/ops/pallas_heads_blocked.py::fused_conv_per_rot_head_blocked
//      (:112, body _blocked_kernel :25, call :141).
// Per object, with the two heads joint as 512 channels ([0:256] head x,
// [256:512] head y) over P = n_pcl + n_kps points:
//   x0 = pf @ W_pt^T + gterm[p < n_pcl ? 0 : 1] + b0        (P, 512), f32
//   a  = GELU(GN64(x0))  rounded to T                       64 groups of 8
//   x1 = per head a[:, h] @ W1_h^T + b1                     (P, 512), f32
//   y  = GELU(GN64(x1))                  K7/K8: rounded to T
//   v  = per head sum_p pw_h[p] * y[p, h]  K7/K8: pw_h rounded to T   (512), f32 sum
//   out = [v_x @ neck_x^T | v_y @ neck_y^T] + bias6          (6)
// K7 and K8 are K3's function but for that one rounding point
// (pallas_heads.py:243-248, pallas_heads_blocked.py:62-67 cast both operands of
// the point reduction to the compute dtype); on the TPU their G objects per grid
// step were ways around the fixed cost of a step. Here the three are one
// kernel: K3 is its instantiation with one object per block and the flag off,
// K7/K8 (the same instantiations behind two wrappers) with G = 2, 4 or 8 objects
// per block and the flag on.
// GELU is the exact erf form (the flax path, layers.py:122); the Pallas
// kernel's tanh stand-in and one-hot GroupNorm matmuls were TPU workarounds.
// Matmul operands are T (bf16 in production, f32 for checks) with f32
// accumulation; everything else is f32, as in the Pallas kernel.
//
// The (2048, 512) f32 activation is 4 MB, which fitted the TPU's VMEM but not
// the 227 KB of shared memory a block may use, and GroupNorm needs
// whole-object statistics before it can normalise. So the work runs as three
// passes over tiles of points, recomputing instead of spilling (a global
// scratch of the layer-1 activation would cost 2 MB per object):
//   (a) layer 0 -> GN0 sums;
//   (b) layer 0 -> GN0 -> GELU -> layer 1 -> GN1 sums;
//   (c) as (b), then GN1 -> GELU -> accumulate pw * y per channel;
// then the (512 -> 6) neck. Layer 0 (K = 64) runs three times and layer 1
// twice: 1.47 GFLOP per object for 0.67 GFLOP of model work.
//
// bf16, the production kernel (`rot_head_wgmma_kernel`). What bounds it on
// the card is not the products but the epilogue between them: 3.1 M GroupNorm
// + exact-erf GELU evaluations per object on the CUDA cores, with libdevice's
// erff about three times the tensor cores' time for the 1.47 GFLOP. The design
// makes the epilogue cheap, keeps everything else out of its way and runs the
// products beside it:
//   - erf is a branch-free degree-7 polynomial under one ex2 (`gelu7` in
//     rot_head_wgmma.cuh, 1.1e-7 absolute), about 19 instructions per GELU with GroupNorm folded into one
//     FMA per element (per-channel scale and shift in shared memory);
//   - the two heads are independent from layer 0 to the neck, so a block takes
//     one (object, head): channels, groups, W1[h], pw[h] and out[3 h : 3 h + 3]
//     are its own, and 2 B blocks fill the card;
//   - the head's weights, W_pt[h] (256 x 64) and W1[h] (256 x 256), 160 KB, are
//     written into shared memory once, in the swizzled panels `wgmma` reads,
//     and stay: no weight is staged again and no barrier guards a stage;
//   - products are `wgmma.m64n128k16` with A from registers (wgmma_tile.cuh):
//     a 64-point tile's features come from shared memory by ldmatrix, and the
//     layer-1 input a = round(GELU(GN0(x0))) is packed straight from the
//     layer-0 accumulators, which have the ownership the next A wants: no
//     activation tile in shared memory, no stores, no barrier;
//   - one producer thread keeps 64-point tiles (8 KB, contiguous in device
//     memory) in flight through a ring of 4 with 1-D bulk copies and
//     mbarriers; two consumer warpgroups take alternate tiles and run out of
//     step, so that one's epilogue runs on the CUDA cores while the other's
//     products run on the tensor cores; `setmaxnreg` moves the producer's
//     registers to the consumers;
//   - inside a pass there is no block-wide barrier. The consumers meet (named
//     barrier, 256 threads) only where statistics are finished: twice after
//     passes (a) and (b), once before the neck;
//   - sums have a fixed order: within a thread over its tiles, across lanes by
//     shuffles, across the eight warps in shared memory in warp order. No
//     atomics; two launches are bit-equal.
// With G objects per block (K7/K8) a block owns (G consecutive objects, one
// head), 2 B / G blocks: the weights are staged, the ring zeroed and its
// mbarriers set up once per block, and the producer's tile sequence runs on
// across the objects (tile i of pass s of object o is o 3 n_tiles + s n_tiles
// + i), so that the next object's tiles are in flight while the consumers
// finish an object's statistics and neck. Ring stage, mbarrier phase and
// warpgroup follow that running number. G is even, so an object's tiles go to
// the same warpgroups (o 3 n_tiles has the parity of the object's index) and
// its sums have the same order at G = 2, 4 and 8: the three are bit-equal.
// What a block gains over K3 is the weight staging of G - 1 objects and the
// overlap at object boundaries; what it loses is parallelism, 2 B / G blocks
// on 132 SMs (B = 256, G = 8: 64 blocks).
//
// f32 (`rot_head_f32_kernel`) exists to hold the arithmetic tightly against
// the plain PyTorch version on the card: `wgmma` has no exact f32 product, so
// it keeps one block per object on `gemm_tile`'s FMA path (common.cuh); K7/K8's
// f32 build is the same kernel looping over G objects a block, where rounding
// to T is the identity, so it is bit-equal to K3's.
#include "rot_head_wgmma.cuh"

using namespace catre;
using namespace catre::rot;

namespace {

struct Params {
  const float* gterm;   // (B, 2, C)
  const float* b0;      // (C)
  const float* gn0s;    // (C)
  const float* gn0b;    // (C)
  const float* b1;      // (C)
  const float* gn1s;    // (C)
  const float* gn1b;    // (C)
  const float* pw;      // (2, P)
  const float* neck;    // (6, F): rows 0..2 head x, 3..5 head y
  const float* bias6;   // (6)
  float* out;           // (B, 6)
  int P;
  int n_pcl;
};

// ================================================================ bf16: wgmma
namespace hopper {

using namespace catre::rot::tc;   // geometry, Who, gelu7, sums: rot_head_wgmma.cuh

constexpr int kStages = 4;                       // tiles in the ring

// Shared memory, from a 1024-byte boundary: [W_pt[h] | W1[h] | ring | red
// (8 warps x F) | ca0 (F) | cb0 (2 x F) | ca1 (F) | cb1 (F) | full, empty
// (kStages each)]. ca / cb are the per-channel scale and shift of GroupNorm
// folded with the bias (cb0 per row kind: cloud point or keypoint); before the
// statistics are known cb0 holds gterm + b0 and cb1 holds b1.
struct Smem {
  unsigned char* wpt;
  unsigned char* w1;
  unsigned char* ring;
  float* red;
  float* ca0;
  float* cb0;
  float* ca1;
  float* cb1;
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit Smem(unsigned char* raw) {
    wpt = raw + ((1024 - (wg::smem_addr(raw) & 1023)) & 1023);
    w1 = wpt + kWptBytes;
    ring = w1 + kW1Bytes;
    red = reinterpret_cast<float*>(ring + kStages * kTileBytes);
    ca0 = red + kConsumerWarps * F;
    cb0 = ca0 + F;
    ca1 = cb0 + 2 * F;
    cb1 = ca1 + F;
    full = reinterpret_cast<uint64_t*>(cb1 + F);
    empty = full + kStages;
  }
};

constexpr size_t smem_bytes() {
  return 1024 + kWptBytes + kW1Bytes + kStages * kTileBytes +
         sizeof(float) * (kConsumerWarps * F + 5 * F) + sizeof(uint64_t) * 2 * kStages;
}
static_assert(smem_bytes() <= 232448, "K3 does not fit a block's shared memory on sm_90");

// x rounded to bf16 to the nearest even and back, as `.to(bfloat16)` rounds:
// the operands of K7/K8's point reduction.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <int N>
__device__ __forceinline__ void round_bf16(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x[i], x[i + 1]);
    x[i] = __low2float(v);
    x[i + 1] = __high2float(v);
  }
}

// One tile of one pass for one consumer warpgroup. PASS 0: GN0 sums of x0;
// 1: GN1 sums of x1; 2: point-weighted sums of y, with y and pw rounded to
// bf16 first if kRound (K7/K8). n is the tile's number in the ring's sequence,
// i its index in the object.
template <int PASS, bool kRound>
__device__ __forceinline__ void tile_pass(const Smem& sm, const Params& q, int h, int n, int i,
                                          const Who& me, float (&sums)[64]) {
  const int stage = n % kStages;
  uint32_t pa[4][4];
  wg::mbar_wait(&sm.full[stage], (n / kStages) & 1);
  wg::load_a_tile(pa, sm.ring + stage * kTileBytes, me.w, me.lane);

  // this thread's two rows; rows past P hold finite stale data and add nothing
  const int r0 = i * kTile + 16 * me.w + me.g, r1 = r0 + 8;
  const bool ok0 = r0 < q.P, ok1 = r1 < q.P;
  const float* add0 = sm.cb0 + (r0 < q.n_pcl ? 0 : F);
  const float* add1 = sm.cb0 + (r1 < q.n_pcl ? 0 : F);
  [[maybe_unused]] uint32_t a[16][4];      // layer-1 input of the tile, 16 k-steps

#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    float acc[64];
    wg::product<4>(acc, pa, sm.wpt, F, half);
    const int c0 = half * wg::kHalfN + 2 * me.t;
    if constexpr (PASS == 0) {
      float s1[16], s2[16];
      take_part<16, 0, 16>(s1, sums, half);
      take_part<16, 32, 48>(s2, sums, half);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const float2 u0 = *reinterpret_cast<const float2*>(add0 + c0 + 8 * jj);
        const float2 u1 = *reinterpret_cast<const float2*>(add1 + c0 + 8 * jj);
        add_group_sums(s1[jj], s2[jj], ok0 ? acc[4 * jj] + u0.x : 0.0f,
                       ok0 ? acc[4 * jj + 1] + u0.y : 0.0f, ok1 ? acc[4 * jj + 2] + u1.x : 0.0f,
                       ok1 ? acc[4 * jj + 3] + u1.y : 0.0f);
      }
      put_part<16, 0, 16>(s1, sums, half);
      put_part<16, 32, 48>(s2, sums, half);
    } else {
      // a = round(GELU(GN0(x0))): n-tiles 2 s, 2 s + 1 are k-step s of layer 1
#pragma unroll
      for (int j0 = 0; j0 < 16; j0 += kJG) {
        float y[4 * kJG];
#pragma unroll
        for (int d = 0; d < kJG; ++d) {
          const int jj = j0 + d;
          const float2 sc = *reinterpret_cast<const float2*>(sm.ca0 + c0 + 8 * jj);
          const float2 u0 = *reinterpret_cast<const float2*>(add0 + c0 + 8 * jj);
          const float2 u1 = *reinterpret_cast<const float2*>(add1 + c0 + 8 * jj);
          y[4 * d] = fmaf(acc[4 * jj], sc.x, u0.x);
          y[4 * d + 1] = fmaf(acc[4 * jj + 1], sc.y, u0.y);
          y[4 * d + 2] = fmaf(acc[4 * jj + 2], sc.x, u1.x);
          y[4 * d + 3] = fmaf(acc[4 * jj + 3], sc.y, u1.y);
        }
        gelu7(y);
#pragma unroll
        for (int d = 0; d < kJG; ++d) {
          const int jj = j0 + d;
          const uint32_t top = wg::pack_a(y[4 * d], y[4 * d + 1]);
          const uint32_t bottom = wg::pack_a(y[4 * d + 2], y[4 * d + 3]);
          if (half) {
            a[8 + jj / 2][2 * (jj % 2)] = top;
            a[8 + jj / 2][2 * (jj % 2) + 1] = bottom;
          } else {
            a[jj / 2][2 * (jj % 2)] = top;
            a[jj / 2][2 * (jj % 2) + 1] = bottom;
          }
        }
      }
    }
  }

  // The stage goes back only now, when products have consumed the registers
  // the tile was loaded into: an arrive right behind the ldmatrix let the next
  // bulk copy overwrite the tile before the loads had read it.
  wg::mbar_arrive(&sm.empty[stage]);

  if constexpr (PASS > 0) {
    float pw0 = 0.0f, pw1 = 0.0f;
    if constexpr (PASS == 2) {
      const float* pwh = q.pw + static_cast<size_t>(h) * q.P;
      pw0 = ok0 ? __ldg(pwh + r0) : 0.0f;
      pw1 = ok1 ? __ldg(pwh + r1) : 0.0f;
      if constexpr (kRound) {
        pw0 = round_bf16(pw0);
        pw1 = round_bf16(pw1);
      }
    }
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float acc[64];
      wg::product<16>(acc, a, sm.w1, F, half);
      const int c0 = half * wg::kHalfN + 2 * me.t;
      if constexpr (PASS == 1) {
        float s1[16], s2[16];
        take_part<16, 0, 16>(s1, sums, half);
        take_part<16, 32, 48>(s2, sums, half);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const float2 u = *reinterpret_cast<const float2*>(sm.cb1 + c0 + 8 * jj);
          add_group_sums(s1[jj], s2[jj], ok0 ? acc[4 * jj] + u.x : 0.0f,
                         ok0 ? acc[4 * jj + 1] + u.y : 0.0f, ok1 ? acc[4 * jj + 2] + u.x : 0.0f,
                         ok1 ? acc[4 * jj + 3] + u.y : 0.0f);
        }
        put_part<16, 0, 16>(s1, sums, half);
        put_part<16, 32, 48>(s2, sums, half);
      } else {
        float v[32];      // sums[32 half + 2 jj + e]: column 128 half + 8 jj + 2 t + e
        take_part<32, 0, 32>(v, sums, half);
#pragma unroll
        for (int j0 = 0; j0 < 16; j0 += kJG) {
          float y[4 * kJG];
#pragma unroll
          for (int d = 0; d < kJG; ++d) {
            const int jj = j0 + d;
            const float2 sc = *reinterpret_cast<const float2*>(sm.ca1 + c0 + 8 * jj);
            const float2 u = *reinterpret_cast<const float2*>(sm.cb1 + c0 + 8 * jj);
            y[4 * d] = fmaf(acc[4 * jj], sc.x, u.x);
            y[4 * d + 1] = fmaf(acc[4 * jj + 1], sc.y, u.y);
            y[4 * d + 2] = fmaf(acc[4 * jj + 2], sc.x, u.x);
            y[4 * d + 3] = fmaf(acc[4 * jj + 3], sc.y, u.y);
          }
          gelu7(y);
          if constexpr (kRound) round_bf16(y);
#pragma unroll
          for (int d = 0; d < kJG; ++d) {
            v[2 * (j0 + d)] += pw0 * y[4 * d] + pw1 * y[4 * d + 2];
            v[2 * (j0 + d) + 1] += pw0 * y[4 * d + 1] + pw1 * y[4 * d + 3];
          }
        }
        put_part<32, 0, 32>(v, sums, half);
      }
    }
  }
}

// All tiles of pass PASS of the object whose tiles start at `base` in the
// ring's sequence that fall to this warpgroup: those whose sequence number is
// even for warpgroup 0, odd for warpgroup 1.
template <int PASS, bool kRound>
__device__ __forceinline__ void run_pass(const Smem& sm, const Params& q, int h, int base,
                                         int n_tiles, const Who& me, float (&sums)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) sums[i] = 0.0f;
  const int first = base + PASS * n_tiles;
  for (int n = first + ((first ^ me.wgi) & 1); n < first + n_tiles; n += 2)
    tile_pass<PASS, kRound>(sm, q, h, n, n - first, me, sums);
}

// gterm + b0 (per row kind) and b1 of the head's channels for object b, before
// its statistics are known; thread c of n_threads writes channels c, c + n_threads, ...
__device__ __forceinline__ void object_terms(const Smem& sm, const Params& q, int b, int h, int c,
                                             int n_threads) {
  const float* gt = q.gterm + static_cast<size_t>(b) * 2 * C + h * F;
  for (; c < F; c += n_threads) {
    sm.cb0[c] = gt[c] + q.b0[h * F + c];
    sm.cb0[F + c] = gt[C + c] + q.b0[h * F + c];
    sm.cb1[c] = q.b1[h * F + c];
  }
}

// Block (g, h) = (blockIdx.x / 2, blockIdx.x % 2): head h of objects GOBJ g ..
// GOBJ g + GOBJ - 1. K3 is <1, false>, K7/K8 <G, true>.
template <int GOBJ, bool kRound>
__global__ void __launch_bounds__(kBlockThreads, 1)
rot_head_wgmma_kernel(const bf16* pf, const bf16* w_pt, const bf16* w1, Params q) {
  extern __shared__ unsigned char raw[];
  const Smem sm(raw);
  const int b0 = (blockIdx.x / 2) * GOBJ, h = blockIdx.x % 2;
  const int P = q.P, n_tiles = (P + kTile - 1) / kTile;
  const int tid = threadIdx.x;

  // the head's weights, once; the ring zeroed so that rows no copy ever
  // fills hold finite values; gterm + b0 and b1 of the first object
  wg::stage_weight(sm.wpt, w_pt + static_cast<size_t>(h) * F * CIN, CIN, F, CIN, tid, kBlockThreads);
  wg::stage_weight(sm.w1, w1 + static_cast<size_t>(h) * F * F, F, F, F, tid, kBlockThreads);
  for (int i = tid; i < kStages * kTileBytes / 16; i += kBlockThreads)
    reinterpret_cast<uint4*>(sm.ring)[i] = make_uint4(0, 0, 0, 0);
  object_terms(sm, q, b0, h, tid, kBlockThreads);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&sm.full[s], 1);       // the producer's arrive, with the copy's bytes
      wg::mbar_init(&sm.empty[s], 128);    // every thread of the warpgroup that read the tile
    }
    wg::mbar_init_fence();
  }
  wg::fence_proxy_async();
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---- producer: tile n of the sequence (three passes over each object in
    // turn) into stage n % 4
    wg::reg_dealloc<kProducerRegs>();
    if (tid == kConsumerThreads) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(pf + static_cast<size_t>(b0) * P * CIN);
      int i = 0;
      [[maybe_unused]] int pass = 0;
      for (int n = 0; n < 3 * n_tiles * GOBJ; ++n) {
        const int stage = n % kStages;
        wg::mbar_wait(&sm.empty[stage], ((n / kStages) & 1) ^ 1);
        const uint32_t bytes = static_cast<uint32_t>(min(kTile, P - i * kTile)) * CIN * 2;
        wg::mbar_arrive_expect_tx(&sm.full[stage], bytes);
        wg::bulk_copy(sm.ring + stage * kTileBytes, src + static_cast<size_t>(i) * kTileBytes,
                      bytes, &sm.full[stage]);
        if (++i == n_tiles) {
          i = 0;
          if constexpr (GOBJ > 1) {
            if (++pass == 3) {       // the next object's points
              pass = 0;
              src += static_cast<size_t>(P) * CIN * 2;
            }
          }
        }
      }
    }
  } else {
    // ---- consumers
    wg::reg_alloc<kConsumerRegs>();
    const Who me;
    const int c = 32 * me.cw + me.lane;      // this thread's channel of the head
    float sums[64], mean, inv;

    // base: the object's first tile in the ring's sequence
#pragma unroll 1
    for (int o = 0; o < GOBJ; ++o) {
      const int b = b0 + o, base = o * 3 * n_tiles;
      if (o > 0) {
        // the last object's neck has read `red`, and every pass of it cb0 / cb1
        consumers_meet();
        object_terms(sm, q, b, h, c, kConsumerThreads);
        consumers_meet();
      }

      run_pass<0, kRound>(sm, q, h, base, n_tiles, me, sums);
      group_stats(sm.red, sums, P, me, mean, inv);
      {
        const float sc = inv * q.gn0s[h * F + c], sh = q.gn0b[h * F + c];
        sm.ca0[c] = sc;
        sm.cb0[c] = (sm.cb0[c] - mean) * sc + sh;
        sm.cb0[F + c] = (sm.cb0[F + c] - mean) * sc + sh;
      }
      consumers_meet();

      run_pass<1, kRound>(sm, q, h, base, n_tiles, me, sums);
      group_stats(sm.red, sums, P, me, mean, inv);
      {
        const float sc = inv * q.gn1s[h * F + c];
        sm.ca1[c] = sc;
        sm.cb1[c] = (sm.cb1[c] - mean) * sc + q.gn1b[h * F + c];
      }
      consumers_meet();

      run_pass<2, kRound>(sm, q, h, base, n_tiles, me, sums);
      // v: over the eight row lanes by shuffles, then over the warps in the neck
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float x = sums[i];
#pragma unroll
        for (int off = 4; off < 32; off *= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
        if (me.g == 0)
          sm.red[me.cw * F + (i / 32) * wg::kHalfN + 8 * ((i % 32) / 2) + 2 * me.t + i % 2] = x;
      }
      consumers_meet();
      // neck: out[3 h + j] = sum_c v[c] * neck[3 h + j, c] + bias6[3 h + j], warp j
      if (me.cw < 3) {
        const int row = 3 * h + me.cw;
        float acc = 0.0f;
        for (int cc = me.lane; cc < F; cc += 32) {
          float v = 0.0f;
#pragma unroll
          for (int w = 0; w < kConsumerWarps; ++w) v += sm.red[w * F + cc];
          acc += v * q.neck[row * F + cc];
        }
        for (int off = 16; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (me.lane == 0) q.out[static_cast<size_t>(b) * 6 + row] = acc + q.bias6[row];
      }
    }
  }
}

template <int GOBJ, bool kRound>
int run(const void* pf, const void* w_pt, const void* w1, const Params& q, int B, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(rot_head_wgmma_kernel<GOBJ, kRound>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  rot_head_wgmma_kernel<GOBJ, kRound>
      <<<2 * B / GOBJ, kBlockThreads, smem_bytes(), static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(pf), static_cast<const bf16*>(w_pt),
          static_cast<const bf16*>(w1), q);
  return static_cast<int>(cudaGetLastError());
}

// The chain the kernel is built on, alone, for a canned check on the card:
// out0 = x @ w0^T (64 x 256, f32) from the staged panels and ldmatrix A
// registers, out1 = round(out0) @ w1^T with the rounded accumulators of the
// first product as the A registers of the second. One warpgroup.
__global__ void __launch_bounds__(128)
wgmma_chain_kernel(const bf16* x, const bf16* w0, const bf16* w1, float* out0, float* out1) {
  extern __shared__ unsigned char raw[];
  const Smem sm(raw);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  wg::stage_weight(sm.wpt, w0, CIN, F, CIN, tid, 128);
  wg::stage_weight(sm.w1, w1, F, F, F, tid, 128);
  for (int i = tid; i < kTileBytes / 16; i += 128)
    reinterpret_cast<uint4*>(sm.ring)[i] = reinterpret_cast<const uint4*>(x)[i];
  wg::fence_proxy_async();
  __syncthreads();

  uint32_t pa[4][4], a[16][4];
  wg::load_a_tile(pa, sm.ring, w, lane);
  auto store = [&](float* out, int half, const float (&acc)[64]) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(16 * w + g + 8 * (e / 2)) * F + half * wg::kHalfN + 8 * j + 2 * t + e % 2] =
            acc[4 * j + e];
  };
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float acc[64];
    wg::product<4>(acc, pa, sm.wpt, F, half);
    store(out0, half, acc);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      a[8 * half + j / 2][2 * (j % 2)] = wg::pack_a(acc[4 * j], acc[4 * j + 1]);
      a[8 * half + j / 2][2 * (j % 2) + 1] = wg::pack_a(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float acc[64];
    wg::product<16>(acc, a, sm.w1, F, half);
    store(out1, half, acc);
  }
}

}  // namespace hopper

// ================================================================ f32: exact FMA
namespace exact {

constexpr int TM = kTileM<float>, MI = TM / 32;

// Shared memory: [red1 | red2 (2 x 128 each) | s1 | s2 | v (C each) |
// mean0 inv0 mean1 inv1 (G each) | point-feature tile (TM x LDP) |
// layer-1 input tile (TM x LDA)].
struct Tiles {
  float* red1;
  float* red2;
  float* s1;     // per-channel sums
  float* s2;     // per-channel sums of squares
  float* v;      // per-channel point-weighted sums
  float* mean0;
  float* inv0;
  float* mean1;
  float* inv1;
  float* pfs;
  float* as;
  __device__ explicit Tiles(unsigned char* smem) {
    red1 = reinterpret_cast<float*>(smem);
    red2 = red1 + 2 * kTileN;
    s1 = red2 + 2 * kTileN;
    s2 = s1 + C;
    v = s2 + C;
    mean0 = v + C;
    inv0 = mean0 + G;
    mean1 = inv0 + G;
    inv1 = mean1 + G;
    pfs = inv1 + G;
    as = pfs + TM * LDP;
  }
};

constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kTileN + 3 * C + 4 * G + TM * (LDP + LDA));
}

// One block per GOBJ objects, in turn: K3 is <1>, K7/K8 <G> (in f32 their
// rounding of the point reduction is the identity, so each object gets K3's bits).
template <int GOBJ>
__global__ void __launch_bounds__(kThreads)
rot_head_f32_kernel(const float* pf, const float* w_pt, const float* w1, Params q) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles t(smem);
  const int P = q.P;
#pragma unroll 1
  for (int o = 0; o < GOBJ; ++o) {
    const int b = blockIdx.x * GOBJ + o;
    const float* pfb = pf + static_cast<size_t>(b) * P * CIN;
    const float* gt = q.gterm + static_cast<size_t>(b) * 2 * C;

    for (int i = threadIdx.x; i < 3 * C; i += kThreads) t.s1[i] = 0.0f;   // s1, s2, v

    // x0 of channel ch at tile row r (point p0 + r)
    auto x0 = [&](int p0, int r, int ch, float acc) {
      return acc + gt[(p0 + r < q.n_pcl ? 0 : C) + ch] + q.b0[ch];
    };

    // ---- pass (a): GN0 statistics of x0
    for (int p0 = 0; p0 < P; p0 += TM) {
      const int rows = min(TM, P - p0);
      load_tile(t.pfs, LDP, pfb + static_cast<size_t>(p0) * CIN, rows, TM, CIN);
      for (int c0 = 0; c0 < C; c0 += kTileN) {
        Acc<MI> acc;
        gemm_tile(acc, t.pfs, LDP, w_pt + static_cast<size_t>(c0) * CIN, CIN, CIN, nullptr);
        add_sums(acc, [&](int r, int c, float a) {
          return r < rows ? x0(p0, r, c0 + c, a) : 0.0f;
        }, t.red1, t.red2, t.s1, t.s2, c0);
      }
    }
    __syncthreads();
    finish_stats(t.s1, t.s2, t.mean0, t.inv0, P);
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * C; i += kThreads) t.s1[i] = 0.0f;   // s1, s2

    // ---- pass (b) (pass == 0): GN1 statistics of x1;
    //      pass (c) (pass == 1): point-weighted sums of y = GELU(GN1(x1))
    for (int pass = 0; pass < 2; ++pass) {
      for (int p0 = 0; p0 < P; p0 += TM) {
        const int rows = min(TM, P - p0);
        load_tile(t.pfs, LDP, pfb + static_cast<size_t>(p0) * CIN, rows, TM, CIN);
        // as = GELU(GN0(x0)) for the whole tile
        for (int c0 = 0; c0 < C; c0 += kTileN) {
          Acc<MI> acc;
          gemm_tile(acc, t.pfs, LDP, w_pt + static_cast<size_t>(c0) * CIN, CIN, CIN, nullptr);
          acc_for_each(acc, [&](int r, int c, float a) {
            const int ch = c0 + c, g = ch / (C / G);
            const float y = (x0(p0, r, ch, a) - t.mean0[g]) * t.inv0[g] * q.gn0s[ch] + q.gn0b[ch];
            t.as[r * LDA + ch] = gelu(y);
          });
        }
        for (int h = 0; h < 2; ++h) {
          const float* pwh = q.pw + static_cast<size_t>(h) * P + p0;
          for (int c0 = 0; c0 < F; c0 += kTileN) {
            const int ch0 = h * F + c0;
            Acc<MI> acc;
            gemm_tile(acc, t.as + h * F, LDA, w1 + static_cast<size_t>(ch0) * F, F, F, nullptr);
            if (pass == 0) {
              add_sums(acc, [&](int r, int c, float a) {
                return r < rows ? a + q.b1[ch0 + c] : 0.0f;
              }, t.red1, t.red2, t.s1, t.s2, ch0);
            } else {
              acc_col_reduce(acc, AddOp(), [&](int r, int c, float a) {
                const int ch = ch0 + c, g = ch / (C / G);
                const float y = (a + q.b1[ch] - t.mean1[g]) * t.inv1[g] * q.gn1s[ch] + q.gn1b[ch];
                return r < rows ? pwh[r] * gelu(y) : 0.0f;
              }, t.red1);
              __syncthreads();
              if (threadIdx.x < kTileN)
                t.v[ch0 + threadIdx.x] += t.red1[threadIdx.x] + t.red1[kTileN + threadIdx.x];
            }
          }
        }
      }
      if (pass == 0) {
        __syncthreads();
        finish_stats(t.s1, t.s2, t.mean1, t.inv1, P);
        __syncthreads();
      }
    }

    // ---- neck: out[j] = sum_c v[head(j), c] * neck[j, c] + bias6[j], one warp per j
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp < 6) {
      const int base = warp < 3 ? 0 : F;
      float acc = 0.0f;
      for (int c = lane; c < F; c += 32) acc += t.v[base + c] * q.neck[warp * F + c];
      for (int off = 16; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) q.out[static_cast<size_t>(b) * 6 + warp] = acc + q.bias6[warp];
    }
    if (o + 1 < GOBJ) __syncthreads();   // v is read before the next object zeroes it
  }
}

template <int GOBJ>
int run(const void* pf, const void* w_pt, const void* w1, const Params& q, int B, void* stream) {
  return launch(rot_head_f32_kernel<GOBJ>, B / GOBJ, smem_bytes(), stream,
                static_cast<const float*>(pf), static_cast<const float*>(w_pt),
                static_cast<const float*>(w1), q);
}

}  // namespace exact
}  // namespace

namespace {

Params params(const void* gterm, const void* b0, const void* gn0s, const void* gn0b,
              const void* b1, const void* gn1s, const void* gn1b, const void* pw,
              const void* neck, const void* bias6, void* out, int P, int n_pcl) {
  Params q;
  q.gterm = static_cast<const float*>(gterm);
  q.b0 = static_cast<const float*>(b0);
  q.gn0s = static_cast<const float*>(gn0s);
  q.gn0b = static_cast<const float*>(gn0b);
  q.b1 = static_cast<const float*>(b1);
  q.gn1s = static_cast<const float*>(gn1s);
  q.gn1b = static_cast<const float*>(gn1b);
  q.pw = static_cast<const float*>(pw);
  q.neck = static_cast<const float*>(neck);
  q.bias6 = static_cast<const float*>(bias6);
  q.out = static_cast<float*>(out);
  q.P = P;
  q.n_pcl = n_pcl;
  return q;
}

template <int GOBJ>
int run_multi(const void* pf, const void* w_pt, const void* w1, const Params& q, int B, int bf16,
              void* stream) {
#if defined(CATRE_K8_NO_ROUND)     // diagnostic build (tools/probe_k8.py): K3's unrounded reduction
  return bf16 ? hopper::run<GOBJ, false>(pf, w_pt, w1, q, B, stream)
#else
  return bf16 ? hopper::run<GOBJ, true>(pf, w_pt, w1, q, B, stream)
#endif
              : exact::run<GOBJ>(pf, w_pt, w1, q, B, stream);
}

}  // namespace

// K3. pf (B, P, 64), w_pt (512, 64) and w1 (2, 256, 256) in T = bf16 if
// `bf16` else f32; every other array f32 as listed in Params; out (B, 6) f32.
extern "C" int catre_rot_head(const void* pf, const void* gterm, const void* w_pt, const void* b0,
                              const void* gn0s, const void* gn0b, const void* w1, const void* b1,
                              const void* gn1s, const void* gn1b, const void* pw, const void* neck,
                              const void* bias6, void* out, int B, int P, int n_pcl, int bf16,
                              void* stream) {
  const Params q = params(gterm, b0, gn0s, gn0b, b1, gn1s, gn1b, pw, neck, bias6, out, P, n_pcl);
  return bf16 ? hopper::run<1, false>(pf, w_pt, w1, q, B, stream)
              : exact::run<1>(pf, w_pt, w1, q, B, stream);
}

// K7/K8: the same arrays, `group` objects per block (2, 4 or 8, dividing B),
// the point reduction's operands rounded to T.
extern "C" int catre_rot_head_multi(const void* pf, const void* gterm, const void* w_pt,
                                    const void* b0, const void* gn0s, const void* gn0b,
                                    const void* w1, const void* b1, const void* gn1s,
                                    const void* gn1b, const void* pw, const void* neck,
                                    const void* bias6, void* out, int B, int P, int n_pcl,
                                    int group, int bf16, void* stream) {
  if (group <= 0 || B % group) return static_cast<int>(cudaErrorInvalidValue);
  const Params q = params(gterm, b0, gn0s, gn0b, b1, gn1s, gn1b, pw, neck, bias6, out, P, n_pcl);
  switch (group) {
    case 2: return run_multi<2>(pf, w_pt, w1, q, B, bf16, stream);
    case 4: return run_multi<4>(pf, w_pt, w1, q, B, bf16, stream);
    case 8: return run_multi<8>(pf, w_pt, w1, q, B, bf16, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x (64, 64), w0 (256, 64), w1 (256, 256) bf16 -> out0, out1 (64, 256) f32:
// the two chained wgmma products of K3 with nothing between them but the
// rounding (see hopper::wgmma_chain_kernel).
extern "C" int catre_wgmma_chain(const void* x, const void* w0, const void* w1, void* out0,
                                 void* out1, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(hopper::wgmma_chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(hopper::smem_bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  hopper::wgmma_chain_kernel<<<1, 128, hopper::smem_bytes(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const catre::bf16*>(x), static_cast<const catre::bf16*>(w0),
      static_cast<const catre::bf16*>(w1), static_cast<float*>(out0), static_cast<float*>(out1));
  return static_cast<int>(cudaGetLastError());
}
