// Backward of both rotation heads (kernel K4): input and parameter gradients
// of the forward in rot_head.cu (K3), given d_out (B, 6).
//
// Replaces the Pallas kernel catre_tpu/ops/pallas_heads_vjp.py::_bwd_kernel
// (:100), launched by _run_bwd_joint (:211) under fused_rot_head_train
// (:263). Per object, with the two heads joint as C = 512 channels over
// P = n_pcl + n_kps points (y0, y1 are the GroupNorm-normalised values):
//   forward   x0 = pf W_pt^T + gterm[p < n_pcl ? 0 : 1] + b0;  h0 = GN0(x0)
//             a = round_T(GELU(h0));  x2 = a W1_h^T + b1;  h1 = GN1(x2)
//             v = sum_p pw_h[p] GELU(h1)
//   backward  d_v = neck^T d_out (per head);  d_neck = v (x) d_out
//             d_h1 = pw (x) d_v * GELU'(h1);  d_pw = sum_c GELU(h1) d_v
//             GN:  d_x = inv (d_y - mean_g(d_y) - y mean_g(d_y y)),  d_y = d_h s
//             d_W1 = d_x2^T a,  d_a = d_x2 W1,  d_h0 = d_a GELU'(h0)
//             d_W_pt = d_x0^T pf,  d_pf = d_x0 W_pt,  d_gterm = sums of d_x0
// GELU' is Phi(x) + x phi(x) on the exact erf; the Pallas kernel's Phi
// polynomial was a TPU stand-in. The W_g / g gradients through gterm and the
// folded neck-bias path stay outside, in autograd (pallas_heads_vjp.py:322-347).
//
// GroupNorm needs whole-object statistics four times (two forward, two
// backward), and an object's (P, 512) f32 activations (4 MB) do not fit the
// 227 KB of shared memory. Two builds answer that differently.
//
// bf16, the production kernel (`hopper::rot_head_bwd_wgmma`): no activation
// ever leaves the block in f32. What bounds it on the card is the epilogue on
// the CUDA cores between the products (GroupNorm, GELU / GELU', sums: about
// 2.6 M evaluations per (object, head)), not the 1.7 GFLOP of products nor
// the bytes. As K3:
//   - one block per (object, head), 2 B blocks: from layer 0 to the neck the
//     heads share only pf on the way in and d_pf on the way out. Each head
//     writes its own f32 d_pf partial and `sum_rows` adds the two in order;
//   - the head's weights, W_pt[h] and W1[h] (160 KB), are staged once as
//     swizzled panels and serve both directions: x2 = a W1^T reads a panel
//     K-major, d_a = d_x2 W1 reads the same bytes MN-major (`product_n64<.,
//     1>`, the instruction's transpose-B flag), likewise W_pt for x0 and d_pf.
//     No transposed copy of a weight exists;
//   - five passes over the object's 64-point tiles, two consumer warpgroups
//     on alternate tiles, the point features fed by the producer's bulk-copy
//     ring where a pass needs them:
//       (A) L0 -> GN0 sums;
//       (B) L0 -> a -> L1 -> GN1 sums; writes a in bf16;
//       (C) a -> L1 -> v, d_pw, and the per-channel sums of d_h1 and d_h1 x2
//           (d_gn1s, d_gn1b, the GN1 backward means);
//       (D) a -> L1 -> d_x2 (packed from the accumulators as the next A) ->
//           d_a = d_x2 W1 by 64-column quarters, each beside a recomputed
//           quarter of x0 -> d_h0 -> per-channel sums of d_h0 and d_h0 x0
//           (d_gn0s, d_gn0b, the GN0 backward means), d_b1; writes d_x2 in bf16;
//       (E) d_x2 -> d_a and x0 by quarters -> d_h0 -> d_x0 -> d_pf partial
//           (accumulated over the quarters), d_b0 and d_gterm (cloud rows and
//           keypoint rows apart); writes d_x0 in bf16.
//     a, d_x2 and d_x0 in bf16 are the operands of the weight-gradient
//     products and have to be written anyway; a later pass of the same block
//     reads a and d_x2 back as A fragments instead of recomputing them, which
//     gives the same bits (they are the rounded operands) with 5 instead of 9
//     GELU-class evaluations per element. What is recomputed is f32: x0 (twice by quarters) and x2
//     (three times), bit-equal from pass to pass, which is what the f32
//     scratch of the other build holds;
//   - those arrays keep every 32 columns in the order that makes a thread's
//     registers 16 contiguous bytes (`stored_column`): a fragment moves in 16
//     instructions a thread instead of 64; the weight gradients come out in
//     that order and `sum_splits` writes them back in the natural one;
//   - GroupNorm and its backward are folded into per-channel vectors in
//     shared memory: h = acc ca + cb, d_x2 = (pw GELU'(h1)) e1 + acc b1c + c1c,
//     d_x0 = d_h0 ca0 + x0 b0c + c0c; GELU and GELU' are `gelu7` /
//     `gelu7_grad` (rot_head_wgmma.cuh), no libdevice call;
//   - per-channel sums over points do not fit the registers beside three
//     fragments: a thread adds its two rows, the eight row lanes of a warp
//     reduce and scatter 16 columns in 14 shuffles (`column_sums`), and the
//     lane that ends up owning a column adds into its warp's row of a
//     shared-memory table; warps are added in warp order at the end of a
//     pass. No atomics; two launches are bit-equal;
//   - the tables take the room of a ring stage: the ring has 3.
// Then `sum_rows` adds the per-object partials over objects, and
// gemm_tn.cuh's `gemm_tn` computes d_W1 = D2^T A per head and d_W_pt = D0^T pf
// over K = B * P rows (a 256 x 256 f32 accumulator does not fit a block's
// registers, so these stay outside the object kernel), fixed split-K.
//
// f32 (`exact::rot_head_bwd_f32`) holds the arithmetic tightly against the
// plain PyTorch version on the card: `wgmma` has no exact f32 product, so it
// keeps one block per object on `gemm_tile`'s FMA path with erff / expf and
// the pre-activations in a global scratch. The wrapper allocates X0, X2
// (B, P, 512) f32 for it alone, and the transposed weight copies.
//   six passes: (1) x0 -> X0, GN0 sums; (2) a = GELU(GN0(X0)) -> A, x2 -> X2,
//   GN1 sums; (3) each thread owns channels t and t + 256 over all points: v,
//   the sums of d_h1 and d_h1 y1, then a warp per point for d_pw; (4) d_x2 ->
//   D2, d_a = d_x2 W1 written over X2's rows; (5) channel-owned sums of d_h0
//   and d_h0 y0; (6) d_x0 -> D0, d_pf = d_x0 W_pt (W_pt^T zero-padded to 128
//   rows), d_b0 and d_gterm.
#include "gemm_tn.cuh"
#include "rot_head_wgmma.cuh"

using namespace catre;
using namespace catre::rot;

namespace {

// Pointer slots of catre_rot_head_bwd, in the order of
// catre_tpu_torch/ops/rot_head_train.py::SLOTS. The bf16 build takes no W1T,
// W_PT_T, X0, X2 (null), the f32 build no PFPART.
enum Slot {
  PF, GTERM, DOUT, W_PT, W1, W1T, W_PT_T, B0, GN0S, GN0B, B1, GN1S, GN1B, PW, NECK,
  X0, X2, ACT, D2, D0, PFPART, POBJ, PPW, PNECK, GPART,
  D_PF, D_GTERM, D_VEC, D_PW, D_NECK, D_W_PT, D_W1,
  kSlots
};

struct Obj {
  const float* gterm;   // (B, 2, C)
  const float* dout;    // (B, 6)
  const float* b0;      // (C)
  const float* gn0s;
  const float* gn0b;
  const float* b1;
  const float* gn1s;
  const float* gn1b;
  const float* pw;      // (2, P)
  const float* neck;    // (6, F)
  float* x0;            // (B, P, C) scratch, f32 build
  float* x2;            // (B, P, C) scratch, f32 build: x2, then d_a
  float* pfpart;        // (2, B, P, CIN): d_pf of each head, bf16 build
  float* pobj;          // (B, 6, C): d_b0, d_gn0s, d_gn0b, d_b1, d_gn1s, d_gn1b
  float* ppw;           // (B, 2, P)
  float* pneck;         // (B, 6, F)
  float* d_pf;          // (B, P, CIN)
  float* d_gterm;       // (B, 2, C)
  int B;
  int P;
  int n_pcl;
};

// ================================================================ bf16: wgmma
namespace hopper {

using namespace catre::rot::tc;   // geometry, Who, gelu7, sums: rot_head_wgmma.cuh

constexpr int kStages = 3;        // tiles in the ring
constexpr int kRingPasses = 4;    // passes that read the point features: all but (C)
constexpr int kTables = 3;        // per-channel sums a pass may keep at once

// Shared memory, from a 1024-byte boundary: [W_pt[h] | W1[h] | ring | tab
// (kTables x 8 warps x F; the first also the scratch of `group_stats`) | 14
// per-channel vectors of F | full, empty (kStages each)].
struct Smem {
  unsigned char* wpt;
  unsigned char* w1;
  unsigned char* ring;
  float* tab;      // tab[k][warp][channel]: sums over the warp's rows of a pass
  float* cbraw;    // (2, F): x0 = acc + cbraw[row kind] (gterm + b0)
  float* cb0;      // (2, F): h0 = acc ca0 + cb0[row kind]
  float* ca0;
  float* sh0;      //         h0 = x0 ca0 + sh0
  float* ca1;
  float* cb1;      // b1 until GN1's statistics are known, then h1 = acc ca1 + cb1
  float* dv;       // d_v
  float* e1;       // d_x2 = (pw GELU'(h1)) e1 + acc b1c + c1c
  float* b1c;
  float* c1c;
  float* b0c;      // d_x0 = d_h0 ca0 + x0 b0c + c0c
  float* c0c;
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit Smem(unsigned char* raw) {
    wpt = raw + ((1024 - (wg::smem_addr(raw) & 1023)) & 1023);
    w1 = wpt + kWptBytes;
    ring = w1 + kW1Bytes;
    tab = reinterpret_cast<float*>(ring + kStages * kTileBytes);
    cbraw = tab + kTables * kConsumerWarps * F;
    cb0 = cbraw + 2 * F;
    ca0 = cb0 + 2 * F;
    sh0 = ca0 + F;
    ca1 = sh0 + F;
    cb1 = ca1 + F;
    dv = cb1 + F;
    e1 = dv + F;
    b1c = e1 + F;
    c1c = b1c + F;
    b0c = c1c + F;
    c0c = b0c + F;
    full = reinterpret_cast<uint64_t*>(c0c + F);
    empty = full + kStages;
  }
};

constexpr size_t smem_bytes() {
  return 1024 + kWptBytes + kW1Bytes + kStages * kTileBytes +
         sizeof(float) * (kTables * kConsumerWarps * F + 14 * F) + sizeof(uint64_t) * 2 * kStages;
}
static_assert(smem_bytes() <= 232448, "K4 does not fit a block's shared memory on sm_90");

// Sums over the warp's 16 rows of 16 columns: v[2 j + e] is this thread's
// value (its two rows already added) for column 8 j + 2 t + e of a 64-column
// quarter, j = 0 .. 7. The eight row lanes g reduce and scatter: each step
// halves the columns a lane still carries, and lane g ends with the two
// columns 8 g + 2 t + e, which are columns 2 lane, 2 lane + 1 of the quarter.
__device__ __forceinline__ float2 column_sums(const float (&v)[16], int g) {
  float u[8], w[4];
  const bool up4 = g & 4, up2 = g & 2, up1 = g & 1;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    u[i] = (up4 ? v[8 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, up4 ? v[i] : v[8 + i], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (up2 ? u[4 + i] : u[i]) + __shfl_xor_sync(0xffffffffu, up2 ? u[i] : u[4 + i], 8);
  float2 r;
  r.x = (up1 ? w[2] : w[0]) + __shfl_xor_sync(0xffffffffu, up1 ? w[0] : w[2], 4);
  r.y = (up1 ? w[3] : w[1]) + __shfl_xor_sync(0xffffffffu, up1 ? w[1] : w[3], 4);
  return r;
}

// ... added into table k at this warp's row, quarter qi: the slot is this
// lane's alone.
__device__ __forceinline__ void add_to_table(const Smem& sm, int k, int qi, const Who& me,
                                             const float (&v)[16]) {
  const float2 r = column_sums(v, me.g);
  float2* slot = reinterpret_cast<float2*>(sm.tab + (k * kConsumerWarps + me.cw) * F +
                                           wg::kQuarterN * qi + 2 * me.lane);
  float2 cur = *slot;
  cur.x += r.x;
  cur.y += r.y;
  *slot = cur;
}

// Channel c's sum of table k over the eight warps, in warp order.
__device__ __forceinline__ float table_sum(const Smem& sm, int k, int c) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kConsumerWarps; ++w) s += sm.tab[(k * kConsumerWarps + w) * F + c];
  return s;
}

__device__ __forceinline__ void clear_tables(const Smem& sm) {
  for (int i = threadIdx.x; i < kTables * kConsumerWarps * F; i += kConsumerThreads)
    sm.tab[i] = 0.0f;
}

// Sum over the 8 channels of this thread's group (8 neighbouring lanes).
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < CPG; off *= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The bf16 operand arrays ACT, D2, D0 (B, P, C) are stored from and loaded
// into A fragments (k-step s: rows g and g + 8, columns 16 s + 8 (i / 2) + 2 t,
// + 1 in register i). In the natural column order a thread would move 4 bytes
// at a time and a warp touch eight lines with every instruction, which cost
// 0.45 ms a pass and array at 512 objects on an H100 (700 W). So inside every
// 32 columns the arrays hold column 8 q + 2 t + e at 8 t + 2 q + e
// (`stored_column`, its own inverse): the eight registers a thread owns of two
// k-steps and one row are 16 contiguous bytes, and a quad's 64. The weight
// gradients, products of these arrays' columns, come out in that order and
// `sum_splits` puts them back. (The f32 build keeps the natural order.)
__host__ __device__ constexpr int stored_column(int c) {
  return (c & ~31) | ((c & 6) << 2) | ((c & 24) >> 2) | (c & 1);
}

// p0 / p1: the thread's two rows at stored column 8 t of the fragment's first column.
template <int KS>
__device__ __forceinline__ void store_fragment(bf16* p0, bf16* p1, const uint32_t (&r)[KS][4],
                                               bool ok0, bool ok1) {
#pragma unroll
  for (int k = 0; k < KS / 2; ++k) {
    if (ok0)
      *reinterpret_cast<uint4*>(p0 + 32 * k) =
          make_uint4(r[2 * k][0], r[2 * k][2], r[2 * k + 1][0], r[2 * k + 1][2]);
    if (ok1)
      *reinterpret_cast<uint4*>(p1 + 32 * k) =
          make_uint4(r[2 * k][1], r[2 * k][3], r[2 * k + 1][1], r[2 * k + 1][3]);
  }
}

// ... and back, what an earlier pass of this block stored (ordinary loads: the
// bytes were written in this launch); a row past P reads as zero.
template <int KS>
__device__ __forceinline__ void load_fragment(uint32_t (&r)[KS][4], const bf16* p0, const bf16* p1,
                                              bool ok0, bool ok1) {
#pragma unroll
  for (int k = 0; k < KS / 2; ++k) {
    const uint4 u0 = ok0 ? *reinterpret_cast<const uint4*>(p0 + 32 * k) : make_uint4(0, 0, 0, 0);
    const uint4 u1 = ok1 ? *reinterpret_cast<const uint4*>(p1 + 32 * k) : make_uint4(0, 0, 0, 0);
    r[2 * k][0] = u0.x;
    r[2 * k][2] = u0.y;
    r[2 * k + 1][0] = u0.z;
    r[2 * k + 1][2] = u0.w;
    r[2 * k][1] = u1.x;
    r[2 * k][3] = u1.y;
    r[2 * k + 1][1] = u1.z;
    r[2 * k + 1][3] = u1.w;
  }
}

// What a consumer thread knows of its two rows of a tile.
struct Rows {
  int r0, r1;           // points of the object
  bool ok0, ok1;        // inside the object
  bool pcl0, pcl1;      // cloud point (else keypoint)
  int kind0, kind1;     // offset of the row kind's vector in cbraw / cb0
  __device__ Rows(int i, const Who& me, int P, int n_pcl) {
    r0 = i * kTile + 16 * me.w + me.g;
    r1 = r0 + 8;
    ok0 = r0 < P;
    ok1 = r1 < P;
    pcl0 = r0 < n_pcl;
    pcl1 = r1 < n_pcl;
    kind0 = pcl0 ? 0 : F;
    kind1 = pcl1 ? 0 : F;
  }
};

// Pointers of one launch beside Obj.
struct Arrays {
  const bf16* pf;
  const bf16* w_pt;
  const bf16* w1;
  bf16* act;    // (B, P, C): a
  bf16* d2;     // (B, P, C): d_x2
  bf16* d0;     // (B, P, C): d_x0
};

// One tile of one pass for one consumer warpgroup; n is the tile's number in
// the ring's sequence, i its index in the object. PASS 0 .. 4 = (A) .. (E);
// `sums` are the per-group sums of passes (A) and (B).
template <int PASS>
__device__ __forceinline__ void tile_pass(const Smem& sm, const Obj& q, const Arrays& arr, int b,
                                          int h, int n, int i, const Who& me, float (&sums)[64]) {
  const int stage = n % kStages;
  // the tile's point features: (A), (B) load them here, (D), (E) for every
  // quarter of x0 anew (four ldmatrix instead of 16 registers held), (C) takes none
  [[maybe_unused]] uint32_t pa[4][4];
  if constexpr (PASS != 2) wg::mbar_wait(&sm.full[stage], (n / kStages) & 1);
  if constexpr (PASS <= 1) wg::load_a_tile(pa, sm.ring + stage * kTileBytes, me.w, me.lane);

  // rows past P hold finite stale data; they add nothing and write nothing
  const Rows rows(i, me, q.P, q.n_pcl);
  [[maybe_unused]] uint32_t a[16][4];      // layer-1 input of the tile, 16 k-steps

  if constexpr (PASS <= 1) {
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
          const float2 u0 = *reinterpret_cast<const float2*>(sm.cbraw + rows.kind0 + c0 + 8 * jj);
          const float2 u1 = *reinterpret_cast<const float2*>(sm.cbraw + rows.kind1 + c0 + 8 * jj);
          add_group_sums(s1[jj], s2[jj], rows.ok0 ? acc[4 * jj] + u0.x : 0.0f,
                         rows.ok0 ? acc[4 * jj + 1] + u0.y : 0.0f,
                         rows.ok1 ? acc[4 * jj + 2] + u1.x : 0.0f,
                         rows.ok1 ? acc[4 * jj + 3] + u1.y : 0.0f);
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
            const float2 u0 = *reinterpret_cast<const float2*>(sm.cb0 + rows.kind0 + c0 + 8 * jj);
            const float2 u1 = *reinterpret_cast<const float2*>(sm.cb0 + rows.kind1 + c0 + 8 * jj);
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
  }

  // The stage goes back only when products have consumed the registers the
  // tile was loaded into (an arrive right behind the ldmatrix lets the next
  // bulk copy overwrite the tile before the loads have read it): here for
  // passes (A) and (B), behind the quarters of x0 for (D) and (E).
  if constexpr (PASS <= 1) wg::mbar_arrive(&sm.empty[stage]);

  if constexpr (PASS == 0) return;

  // this thread's rows in the (B, P, C) operand arrays, at the head's stored column 8 t
  const size_t obj = static_cast<size_t>(b) * q.P;
  const size_t e0 = (obj + rows.r0) * C + h * F + 8 * me.t;
  const size_t e1 = (obj + rows.r1) * C + h * F + 8 * me.t;
  // a is written by (B) and read back by (C) and (D), d_x2 written by (D) and
  // read back by (E): the bits a recomputation would give, for 16 loads a thread
  if constexpr (PASS == 1) store_fragment<16>(arr.act + e0, arr.act + e1, a, rows.ok0, rows.ok1);
  if constexpr (PASS >= 2) load_fragment<16>(a, arr.act + e0, arr.act + e1, rows.ok0, rows.ok1);

  float pw0 = 0.0f, pw1 = 0.0f;
  if constexpr (PASS == 2 || PASS == 3) {
    const float* pwh = q.pw + static_cast<size_t>(h) * q.P;
    pw0 = rows.ok0 ? __ldg(pwh + rows.r0) : 0.0f;
    pw1 = rows.ok1 ? __ldg(pwh + rows.r1) : 0.0f;
  }
  [[maybe_unused]] float row_sum0 = 0.0f, row_sum1 = 0.0f;   // (C): d_pw of the two rows
  [[maybe_unused]] uint32_t d2a[16][4];                      // (D), (E): d_x2 as the next A
  if constexpr (PASS == 4) load_fragment<16>(d2a, arr.d2 + e0, arr.d2 + e1, rows.ok0, rows.ok1);

  if constexpr (PASS <= 3) {
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
          add_group_sums(s1[jj], s2[jj], rows.ok0 ? acc[4 * jj] + u.x : 0.0f,
                         rows.ok0 ? acc[4 * jj + 1] + u.y : 0.0f,
                         rows.ok1 ? acc[4 * jj + 2] + u.x : 0.0f,
                         rows.ok1 ? acc[4 * jj + 3] + u.y : 0.0f);
        }
        put_part<16, 0, 16>(s1, sums, half);
        put_part<16, 32, 48>(s2, sums, half);
      } else {
        // by quarters of 8 n-tiles: one `column_sums` each
#pragma unroll
        for (int q2 = 0; q2 < 2; ++q2) {
          [[maybe_unused]] float sv[16], sd[16], sdx[16];
#pragma unroll
          for (int j0 = 0; j0 < 8; j0 += kJG) {
            float y[4 * kJG], dg[4 * kJG];
#pragma unroll
            for (int d = 0; d < kJG; ++d) {
              const int jj = 8 * q2 + j0 + d;
              const float2 sc = *reinterpret_cast<const float2*>(sm.ca1 + c0 + 8 * jj);
              const float2 u = *reinterpret_cast<const float2*>(sm.cb1 + c0 + 8 * jj);
              y[4 * d] = fmaf(acc[4 * jj], sc.x, u.x);
              y[4 * d + 1] = fmaf(acc[4 * jj + 1], sc.y, u.y);
              y[4 * d + 2] = fmaf(acc[4 * jj + 2], sc.x, u.x);
              y[4 * d + 3] = fmaf(acc[4 * jj + 3], sc.y, u.y);
            }
            gelu7_grad(y, dg);
#pragma unroll
            for (int d = 0; d < kJG; ++d) {
              const int jq = j0 + d, jj = 8 * q2 + jq;
              if constexpr (PASS == 2) {
                const float2 dvv = *reinterpret_cast<const float2*>(sm.dv + c0 + 8 * jj);
                sv[2 * jq] = pw0 * y[4 * d] + pw1 * y[4 * d + 2];
                sv[2 * jq + 1] = pw0 * y[4 * d + 1] + pw1 * y[4 * d + 3];
                row_sum0 += y[4 * d] * dvv.x + y[4 * d + 1] * dvv.y;
                row_sum1 += y[4 * d + 2] * dvv.x + y[4 * d + 3] * dvv.y;
                const float dh00 = pw0 * dvv.x * dg[4 * d], dh01 = pw0 * dvv.y * dg[4 * d + 1];
                const float dh10 = pw1 * dvv.x * dg[4 * d + 2], dh11 = pw1 * dvv.y * dg[4 * d + 3];
                sd[2 * jq] = dh00 + dh10;
                sd[2 * jq + 1] = dh01 + dh11;
                sdx[2 * jq] = dh00 * acc[4 * jj] + dh10 * acc[4 * jj + 2];
                sdx[2 * jq + 1] = dh01 * acc[4 * jj + 1] + dh11 * acc[4 * jj + 3];
              } else {
                const float2 ev = *reinterpret_cast<const float2*>(sm.e1 + c0 + 8 * jj);
                const float2 bv = *reinterpret_cast<const float2*>(sm.b1c + c0 + 8 * jj);
                const float2 cv = *reinterpret_cast<const float2*>(sm.c1c + c0 + 8 * jj);
                // d_x2; a row past P is zero here and so in everything behind it
              auto d_x2 = [&](bool ok, float pw, int e, float scale, float slope, float shift) {
                return ok ? fmaf(pw * dg[4 * d + e], scale, fmaf(acc[4 * jj + e], slope, shift))
                          : 0.0f;
              };
              const float dx00 = d_x2(rows.ok0, pw0, 0, ev.x, bv.x, cv.x);
              const float dx01 = d_x2(rows.ok0, pw0, 1, ev.y, bv.y, cv.y);
              const float dx10 = d_x2(rows.ok1, pw1, 2, ev.x, bv.x, cv.x);
              const float dx11 = d_x2(rows.ok1, pw1, 3, ev.y, bv.y, cv.y);
              sd[2 * jq] = dx00 + dx10;
                sd[2 * jq + 1] = dx01 + dx11;
                const uint32_t top = wg::pack_a(dx00, dx01), bottom = wg::pack_a(dx10, dx11);
                if (half) {
                  d2a[8 + jj / 2][2 * (jj % 2)] = top;
                  d2a[8 + jj / 2][2 * (jj % 2) + 1] = bottom;
                } else {
                  d2a[jj / 2][2 * (jj % 2)] = top;
                  d2a[jj / 2][2 * (jj % 2) + 1] = bottom;
                }
              }
            }
          }
          const int qi = 2 * half + q2;
          if constexpr (PASS == 2) {
            add_to_table(sm, 0, qi, me, sv);
            add_to_table(sm, 1, qi, me, sd);
            add_to_table(sm, 2, qi, me, sdx);
          } else {
            add_to_table(sm, 0, qi, me, sd);      // d_b1
          }
        }
      }
    }
  }

  if constexpr (PASS == 2) {
    // d_pw of this thread's rows: over the quad's columns
    row_sum0 += __shfl_xor_sync(0xffffffffu, row_sum0, 1);
    row_sum0 += __shfl_xor_sync(0xffffffffu, row_sum0, 2);
    row_sum1 += __shfl_xor_sync(0xffffffffu, row_sum1, 1);
    row_sum1 += __shfl_xor_sync(0xffffffffu, row_sum1, 2);
    float* ppw = q.ppw + (static_cast<size_t>(b) * 2 + h) * q.P;
    if (me.t == 0 && rows.ok0) ppw[rows.r0] = row_sum0;
    if (me.t == 0 && rows.ok1) ppw[rows.r1] = row_sum1;
  }

  if constexpr (PASS >= 3) {
    if constexpr (PASS == 3) store_fragment<16>(arr.d2 + e0, arr.d2 + e1, d2a, rows.ok0, rows.ok1);
    [[maybe_unused]] float pfacc[32];       // (E): d_pf of the tile, over the quarters
#pragma unroll 1
    for (int qi = 0; qi < 4; ++qi) {
      float dacc[32], x0[32];
      // d_a[:, quarter] = d_x2 W1[:, quarter]: panel qi of W1 read transposed
      wg::product_n64<16, 1>(dacc, d2a, sm.w1 + qi * (F * wg::kRowBytes), wg::kKStepRowsUnits,
                             0);
      // x0[:, quarter] again: rows 64 qi .. of W_pt's panel
      uint32_t pa[4][4];
      wg::load_a_tile(pa, sm.ring + stage * kTileBytes, me.w, me.lane);
      wg::product_n64<4, 0>(x0, pa, sm.wpt + qi * (wg::kQuarterN * wg::kRowBytes),
                            wg::kKStepUnits, 0);
      const int c0 = wg::kQuarterN * qi + 2 * me.t;
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += kJG) {
        float y[4 * kJG], dg[4 * kJG];
        float2 sc[kJG];
#pragma unroll
        for (int d = 0; d < kJG; ++d) {
          const int jj = j0 + d;
          sc[d] = *reinterpret_cast<const float2*>(sm.ca0 + c0 + 8 * jj);
          const float2 sh = *reinterpret_cast<const float2*>(sm.sh0 + c0 + 8 * jj);
          const float2 u0 = *reinterpret_cast<const float2*>(sm.cbraw + rows.kind0 + c0 + 8 * jj);
          const float2 u1 = *reinterpret_cast<const float2*>(sm.cbraw + rows.kind1 + c0 + 8 * jj);
          x0[4 * jj] += u0.x;
          x0[4 * jj + 1] += u0.y;
          x0[4 * jj + 2] += u1.x;
          x0[4 * jj + 3] += u1.y;
          y[4 * d] = fmaf(x0[4 * jj], sc[d].x, sh.x);
          y[4 * d + 1] = fmaf(x0[4 * jj + 1], sc[d].y, sh.y);
          y[4 * d + 2] = fmaf(x0[4 * jj + 2], sc[d].x, sh.x);
          y[4 * d + 3] = fmaf(x0[4 * jj + 3], sc[d].y, sh.y);
        }
        gelu7_grad(y, dg);
#pragma unroll
        for (int d = 0; d < kJG; ++d) {
          const int jj = j0 + d;
#pragma unroll
          for (int e = 0; e < 4; ++e) dacc[4 * jj + e] *= dg[4 * d + e];     // d_h0
          if constexpr (PASS == 4) {
            const float2 bv = *reinterpret_cast<const float2*>(sm.b0c + c0 + 8 * jj);
            const float2 cv = *reinterpret_cast<const float2*>(sm.c0c + c0 + 8 * jj);
            // d_x0, zero for a row past P
            auto d_x0 = [&](bool ok, int e, float scale, float slope, float shift) {
              return ok ? fmaf(dacc[4 * jj + e], scale, fmaf(x0[4 * jj + e], slope, shift)) : 0.0f;
            };
            dacc[4 * jj] = d_x0(rows.ok0, 0, sc[d].x, bv.x, cv.x);
            dacc[4 * jj + 1] = d_x0(rows.ok0, 1, sc[d].y, bv.y, cv.y);
            dacc[4 * jj + 2] = d_x0(rows.ok1, 2, sc[d].x, bv.x, cv.x);
            dacc[4 * jj + 3] = d_x0(rows.ok1, 3, sc[d].y, bv.y, cv.y);
          }
        }
      }
      float sv[16];
      if constexpr (PASS == 3) {
        // sums of d_h0 and of d_h0 x0 (rows past P have d_h0 = 0)
#pragma unroll
        for (int k = 0; k < 16; ++k) sv[k] = dacc[4 * (k / 2) + k % 2] + dacc[4 * (k / 2) + 2 + k % 2];
        add_to_table(sm, 1, qi, me, sv);
#pragma unroll
        for (int k = 0; k < 16; ++k)
          sv[k] = dacc[4 * (k / 2) + k % 2] * x0[4 * (k / 2) + k % 2] +
                  dacc[4 * (k / 2) + 2 + k % 2] * x0[4 * (k / 2) + 2 + k % 2];
        add_to_table(sm, 2, qi, me, sv);
      } else {
        // d_x0: sums over cloud rows and over keypoint rows, the bf16 operand
        // of d_W_pt, and as the next A: d_pf += d_x0[:, quarter] W_pt[quarter]
#pragma unroll
        for (int k = 0; k < 16; ++k)
          sv[k] = (rows.pcl0 ? dacc[4 * (k / 2) + k % 2] : 0.0f) +
                  (rows.pcl1 ? dacc[4 * (k / 2) + 2 + k % 2] : 0.0f);
        add_to_table(sm, 0, qi, me, sv);
#pragma unroll
        for (int k = 0; k < 16; ++k)
          sv[k] = (rows.pcl0 ? 0.0f : dacc[4 * (k / 2) + k % 2]) +
                  (rows.pcl1 ? 0.0f : dacc[4 * (k / 2) + 2 + k % 2]);
        add_to_table(sm, 1, qi, me, sv);
        uint32_t d0a[4][4];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          d0a[jj / 2][2 * (jj % 2)] = wg::pack_a(dacc[4 * jj], dacc[4 * jj + 1]);
          d0a[jj / 2][2 * (jj % 2) + 1] = wg::pack_a(dacc[4 * jj + 2], dacc[4 * jj + 3]);
        }
        store_fragment<4>(arr.d0 + e0 + wg::kQuarterN * qi, arr.d0 + e1 + wg::kQuarterN * qi, d0a,
                          rows.ok0, rows.ok1);
        wg::product_n64<4, 1>(pfacc, d0a, sm.wpt + qi * (wg::kQuarterN * wg::kRowBytes),
                              wg::kKStepRowsUnits, qi > 0);
      }
    }
    wg::mbar_arrive(&sm.empty[stage]);
    if constexpr (PASS == 4) {
      float* part = q.pfpart + (static_cast<size_t>(h) * q.B * q.P + obj) * CIN + 2 * me.t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (rows.ok0)
          *reinterpret_cast<float2*>(part + static_cast<size_t>(rows.r0) * CIN + 8 * j) =
              make_float2(pfacc[4 * j], pfacc[4 * j + 1]);
        if (rows.ok1)
          *reinterpret_cast<float2*>(part + static_cast<size_t>(rows.r1) * CIN + 8 * j) =
              make_float2(pfacc[4 * j + 2], pfacc[4 * j + 3]);
      }
    }
  }
}

// All tiles of pass PASS that fall to this warpgroup: those whose sequence
// number is even for warpgroup 0, odd for warpgroup 1.
template <int PASS>
__device__ __forceinline__ void run_pass(const Smem& sm, const Obj& q, const Arrays& arr, int b,
                                         int h, int n_tiles, const Who& me, float (&sums)[64]) {
  if constexpr (PASS < 2) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sums[i] = 0.0f;
  }
  const int first = (PASS < 2 ? PASS : PASS - 1) * n_tiles;     // (C) is not in the ring's sequence
  for (int n = first + ((first ^ me.wgi) & 1); n < first + n_tiles; n += 2)
    tile_pass<PASS>(sm, q, arr, b, h, n, n - first, me, sums);
}

__global__ void __launch_bounds__(kBlockThreads, 1)
rot_head_bwd_wgmma(Arrays arr, Obj q) {
  extern __shared__ unsigned char raw[];
  const Smem sm(raw);
  const int b = blockIdx.x / 2, h = blockIdx.x % 2;
  const int P = q.P, n_tiles = (P + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const float* dout = q.dout + static_cast<size_t>(b) * 6 + 3 * h;

  // the head's weights, once; the ring zeroed so that rows no copy ever
  // fills hold finite values; gterm + b0, b1 and d_v of the head's channels
  wg::stage_weight(sm.wpt, arr.w_pt + static_cast<size_t>(h) * F * CIN, CIN, F, CIN, tid,
                   kBlockThreads);
  wg::stage_weight(sm.w1, arr.w1 + static_cast<size_t>(h) * F * F, F, F, F, tid, kBlockThreads);
  for (int i = tid; i < kStages * kTileBytes / 16; i += kBlockThreads)
    reinterpret_cast<uint4*>(sm.ring)[i] = make_uint4(0, 0, 0, 0);
  const float* gt = q.gterm + static_cast<size_t>(b) * 2 * C + h * F;
  for (int c = tid; c < F; c += kBlockThreads) {
    sm.cbraw[c] = gt[c] + q.b0[h * F + c];
    sm.cbraw[F + c] = gt[C + c] + q.b0[h * F + c];
    sm.cb1[c] = q.b1[h * F + c];
    float dv = 0.0f;
    for (int j = 0; j < 3; ++j) dv += dout[j] * q.neck[(3 * h + j) * F + c];
    sm.dv[c] = dv;
  }
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
    // ---- producer: tile n of the sequence (four passes over the object) into stage n % 3
    wg::reg_dealloc<kProducerRegs>();
    if (tid == kConsumerThreads) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(arr.pf + static_cast<size_t>(b) * P * CIN);
      int i = 0;
      for (int n = 0; n < kRingPasses * n_tiles; ++n) {
        const int stage = n % kStages;
        wg::mbar_wait(&sm.empty[stage], ((n / kStages) & 1) ^ 1);
        const uint32_t bytes = static_cast<uint32_t>(min(kTile, P - i * kTile)) * CIN * 2;
        wg::mbar_arrive_expect_tx(&sm.full[stage], bytes);
        wg::bulk_copy(sm.ring + stage * kTileBytes, src + static_cast<size_t>(i) * kTileBytes,
                      bytes, &sm.full[stage]);
        if (++i == n_tiles) i = 0;
      }
    }
  } else {
    // ---- consumers
    wg::reg_alloc<kConsumerRegs>();
    const Who me;
    const int c = 32 * me.cw + me.lane;      // this thread's channel of the head
    const int ch = h * F + c;                // ... of the joint 512
    const float n_group = static_cast<float>(P) * CPG;
    float* pobj = q.pobj + static_cast<size_t>(b) * 6 * C + ch;
    float sums[64], mean0, inv0, mean1, inv1;

    run_pass<0>(sm, q, arr, b, h, n_tiles, me, sums);
    group_stats(sm.tab, sums, P, me, mean0, inv0);
    const float gn0s = q.gn0s[ch];
    {
      const float sc = inv0 * gn0s, sh = q.gn0b[ch] - mean0 * sc;
      sm.ca0[c] = sc;
      sm.sh0[c] = sh;
      sm.cb0[c] = fmaf(sm.cbraw[c], sc, sh);
      sm.cb0[F + c] = fmaf(sm.cbraw[F + c], sc, sh);
    }
    consumers_meet();

    run_pass<1>(sm, q, arr, b, h, n_tiles, me, sums);
    group_stats(sm.tab, sums, P, me, mean1, inv1);
    const float gn1s = q.gn1s[ch];
    const float b1_centred = sm.cb1[c] - mean1;      // x2 - mean1 = acc + this
    {
      const float sc = inv1 * gn1s;
      sm.ca1[c] = sc;
      sm.cb1[c] = fmaf(b1_centred, sc, q.gn1b[ch]);
    }
    consumers_meet();      // every read of tab's statistics scratch is done
    clear_tables(sm);
    consumers_meet();

    run_pass<2>(sm, q, arr, b, h, n_tiles, me, sums);
    consumers_meet();
    {
      const float v = table_sum(sm, 0, c), sd = table_sum(sm, 1, c), sdx = table_sum(sm, 2, c);
      const float sdy = inv1 * fmaf(b1_centred, sd, sdx);      // sum of d_h1 y1
      pobj[4 * C] = sdy;     // d_gn1s
      pobj[5 * C] = sd;      // d_gn1b
      for (int j = 0; j < 3; ++j)
        q.pneck[(static_cast<size_t>(b) * 6 + 3 * h + j) * F + c] = v * dout[j];
      const float gm1 = group_sum(gn1s * sd) / n_group, gm2 = group_sum(gn1s * sdy) / n_group;
      sm.e1[c] = sm.dv[c] * sm.ca1[c];
      sm.b1c[c] = -inv1 * inv1 * gm2;
      sm.c1c[c] = -inv1 * gm1 - b1_centred * inv1 * inv1 * gm2;
    }
    consumers_meet();
    clear_tables(sm);
    consumers_meet();

    run_pass<3>(sm, q, arr, b, h, n_tiles, me, sums);
    consumers_meet();
    {
      const float db1 = table_sum(sm, 0, c), sd = table_sum(sm, 1, c), sdx = table_sum(sm, 2, c);
      const float sdy = inv0 * fmaf(-mean0, sd, sdx);          // sum of d_h0 y0
      pobj[3 * C] = db1;
      pobj[1 * C] = sdy;     // d_gn0s
      pobj[2 * C] = sd;      // d_gn0b
      const float gm1 = group_sum(gn0s * sd) / n_group, gm2 = group_sum(gn0s * sdy) / n_group;
      sm.b0c[c] = -inv0 * inv0 * gm2;
      sm.c0c[c] = -inv0 * gm1 + mean0 * inv0 * inv0 * gm2;
    }
    consumers_meet();
    clear_tables(sm);
    consumers_meet();

    run_pass<4>(sm, q, arr, b, h, n_tiles, me, sums);
    consumers_meet();
    {
      const float d_pcl = table_sum(sm, 0, c), d_kps = table_sum(sm, 1, c);
      float* dg = q.d_gterm + static_cast<size_t>(b) * 2 * C + ch;
      dg[0] = d_pcl;
      dg[C] = d_kps;
      pobj[0] = d_pcl + d_kps;     // d_b0
    }
  }
}

// out[z][m][n] = sum over s of part[s][z][stored(m)][stored(n)] (n as it is
// unless PERM_N), s = 0 .. splits - 1 in order: `sum_rows` for a product of
// arrays in the fragments' column order. M and N are multiples of 32.
template <bool PERM_N>
__global__ void __launch_bounds__(kThreads)
sum_splits(const float* part, float* out, int splits, int n, int N) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int r = 0; r < splits; ++r) s += part[static_cast<size_t>(r) * n + i];
  const int zm = i / N, col = i % N;      // the 32-column blocks do not straddle a z
  out[static_cast<size_t>(stored_column(zm)) * N + (PERM_N ? stored_column(col) : col)] = s;
}

// `product_tn` (gemm_tn.cuh) with X's columns, and Y's if PERM_N, in the
// fragments' order: the same split-K partials, summed into the natural order.
template <bool PERM_N>
int product_tn_stored(const bf16* X, int ldx, const bf16* Y, int ldy, int zoff, int Z, int M, int N,
                      long long K, int splits, float* part, float* out, void* stream) {
  const long long chunk = (K + splits - 1) / splits;
  const int tiles = (M / kTnRows) * ((N + kTnRows - 1) / kTnRows);
  int err = launch(gemm_tn<bf16>, dim3(tiles, splits, Z), tn_smem_bytes<bf16>(), stream, X, ldx, Y,
                   ldy, zoff, M, N, K, chunk, part);
  if (err) return err;
  const int n = Z * M * N;
  return launch(sum_splits<PERM_N>, (n + kThreads - 1) / kThreads, 0, stream,
                static_cast<const float*>(part), out, splits, n, N);
}

int run(void* const* ptr, const Obj& q, int splits, void* stream) {
  Arrays arr;
  arr.pf = static_cast<const bf16*>(ptr[PF]);
  arr.w_pt = static_cast<const bf16*>(ptr[W_PT]);
  arr.w1 = static_cast<const bf16*>(ptr[W1]);
  arr.act = static_cast<bf16*>(ptr[ACT]);
  arr.d2 = static_cast<bf16*>(ptr[D2]);
  arr.d0 = static_cast<bf16*>(ptr[D0]);
  cudaError_t err = cudaFuncSetAttribute(rot_head_bwd_wgmma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  rot_head_bwd_wgmma<<<2 * q.B, kBlockThreads, smem_bytes(), static_cast<cudaStream_t>(stream)>>>(
      arr, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // d_pf = the two heads' partials, head x first
  const int n = q.B * q.P * CIN;
  int rc = launch(sum_rows, (n + kThreads - 1) / kThreads, 0, stream,
                  static_cast<const float*>(q.pfpart), q.d_pf, 2, n);
  if (rc) return rc;
  // d_W1 = D2^T A per head, d_W_pt = D0^T pf over K = B * P rows
  const long long K = static_cast<long long>(q.B) * q.P;
  float* part = static_cast<float*>(ptr[GPART]);
  rc = product_tn_stored<true>(arr.d2, C, arr.act, C, F, 2, F, F, K, splits, part,
                               static_cast<float*>(ptr[D_W1]), stream);
  if (rc) return rc;
  return product_tn_stored<false>(arr.d0, C, arr.pf, CIN, 0, 1, C, CIN, K, splits, part,
                                  static_cast<float*>(ptr[D_W_PT]), stream);
}

// The backward products alone, for a canned check on the card: with x (64 x
// 256) as the A registers of 16 k-steps,
//   out_w1 (64 x 256) = x @ w1, panel by panel read transposed;
//   out_wpt (64 x 64) = x @ w0, accumulated over four quarters of w0's rows;
//   out_l0 (64 x 256) = x[:, :64] @ w0^T by 64-column quarters (K-major).
// One warpgroup.
__global__ void __launch_bounds__(128)
wgmma_tn_kernel(const bf16* x, const bf16* w0, const bf16* w1, float* out_w1, float* out_wpt,
                float* out_l0) {
  extern __shared__ unsigned char raw[];
  const Smem sm(raw);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  wg::stage_weight(sm.wpt, w0, CIN, F, CIN, tid, 128);
  wg::stage_weight(sm.w1, w1, F, F, F, tid, 128);
  // x as four 64 x 64 tiles of 128-byte rows in the ring's place (32 KB of tab follow it)
  for (int i = tid; i < 64 * 32; i += 128) {
    const int r = i / 32, c = i % 32;      // 16-byte chunk c of row r
    reinterpret_cast<uint4*>(sm.ring + (c / 8) * kTileBytes + r * wg::kRowBytes)[c % 8] =
        reinterpret_cast<const uint4*>(x + r * F)[c];
  }
  wg::fence_proxy_async();
  __syncthreads();

  uint32_t a[16][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t part[4][4];
    wg::load_a_tile(part, sm.ring + k * kTileBytes, w, lane);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[4 * k + s][e] = part[s][e];
  }
  auto store = [&](float* out, int ld, int col0, const float (&acc)[32]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(16 * w + g + 8 * (e / 2)) * ld + col0 + 8 * j + 2 * t + e % 2] = acc[4 * j + e];
  };
  float pfacc[32];
#pragma unroll 1
  for (int qi = 0; qi < 4; ++qi) {
    float acc[32];
    wg::product_n64<16, 1>(acc, a, sm.w1 + qi * (F * wg::kRowBytes), wg::kKStepRowsUnits, 0);
    store(out_w1, F, wg::kQuarterN * qi, acc);
    uint32_t first[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) first[s][e] = a[s][e];
    wg::product_n64<4, 0>(acc, first, sm.wpt + qi * (wg::kQuarterN * wg::kRowBytes),
                          wg::kKStepUnits, 0);
    store(out_l0, F, wg::kQuarterN * qi, acc);
    // x[:, 64 qi : 64 qi + 64] @ w0[64 qi : 64 qi + 64, :]: k-steps 4 qi .. 4 qi + 3
    uint32_t part[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[s][e] = qi == 0 ? a[s][e] : qi == 1 ? a[4 + s][e] : qi == 2 ? a[8 + s][e] : a[12 + s][e];
    wg::product_n64<4, 1>(pfacc, part, sm.wpt + qi * (wg::kQuarterN * wg::kRowBytes),
                          wg::kKStepRowsUnits, qi > 0);
  }
  store(out_wpt, CIN, 0, pfacc);
}

}  // namespace hopper

// ================================================================ f32: exact FMA
namespace exact {

constexpr int TM = kTileM<float>, MI = TM / 32;

// Shared memory: [red1 | red2 (2 x 128 each) | s1 | s2 | dv (C each) |
// mean0 inv0 mean1 inv1 gm1 gm2 (G each) | point-feature tile
// (TM x LDP) | 512-wide operand tile (TM x LDA)].
struct Tiles {
  float* red1;
  float* red2;
  float* s1;
  float* s2;
  float* dv;     // d_v per channel
  float* mean0;
  float* inv0;
  float* mean1;
  float* inv1;
  float* gm1;    // GN backward group means of d_y
  float* gm2;    // and of d_y * y
  float* pfs;
  float* as;
  __device__ explicit Tiles(unsigned char* smem) {
    red1 = reinterpret_cast<float*>(smem);
    red2 = red1 + 2 * kTileN;
    s1 = red2 + 2 * kTileN;
    s2 = s1 + C;
    dv = s2 + C;
    mean0 = dv + C;
    inv0 = mean0 + G;
    mean1 = inv0 + G;
    inv1 = mean1 + G;
    gm1 = inv1 + G;
    gm2 = gm1 + G;
    pfs = gm2 + G;
    as = pfs + TM * LDP;
  }
};

constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kTileN + 3 * C + 6 * G + TM * (LDP + LDA));
}

// GN backward group means from per-channel sums: gm1[g] = sum_c s[c] S1[c] / n,
// gm2[g] = sum_c s[c] S2[c] / n over the group's channels (s1, s2 hold s S1
// and s S2). All threads call it; it synchronises before and after.
__device__ inline void backward_means(const float* s1, const float* s2, float* gm1, float* gm2,
                                      int P) {
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float a = 0.0f, b = 0.0f;
    for (int j = 0; j < CPG; ++j) {
      a += s1[g * CPG + j];
      b += s2[g * CPG + j];
    }
    const float n = static_cast<float>(P) * CPG;
    gm1[g] = a / n;
    gm2[g] = b / n;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
rot_head_bwd_f32(const float* pf, const float* w_pt, const float* w1, const float* w1t,
                 const float* w_pt_t, float* act, float* d2, float* d0, Obj q) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles t(smem);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int P = q.P;
  const size_t obj = static_cast<size_t>(b) * P;
  const float* pfb = pf + obj * CIN;
  const float* gt = q.gterm + static_cast<size_t>(b) * 2 * C;
  const float* dout = q.dout + static_cast<size_t>(b) * 6;
  float* x0b = q.x0 + obj * C;
  float* x2b = q.x2 + obj * C;
  float* actb = act + obj * C;
  float* d2b = d2 + obj * C;
  float* d0b = d0 + obj * C;
  float* pobj = q.pobj + static_cast<size_t>(b) * 6 * C;

  for (int i = tid; i < 2 * C; i += kThreads) t.s1[i] = 0.0f;   // s1, s2
  for (int c = tid; c < C; c += kThreads) {
    const int h = c / F;
    float a = 0.0f;
    for (int j = 3 * h; j < 3 * h + 3; ++j) a += dout[j] * q.neck[j * F + c % F];
    t.dv[c] = a;
  }

  // ---- (1) x0 -> X0, GN0 sums
  for (int p0 = 0; p0 < P; p0 += TM) {
    const int rows = min(TM, P - p0);
    load_tile(t.pfs, LDP, pfb + static_cast<size_t>(p0) * CIN, rows, TM, CIN);
    for (int c0 = 0; c0 < C; c0 += kTileN) {
      Acc<MI> acc;
      gemm_tile(acc, t.pfs, LDP, w_pt + static_cast<size_t>(c0) * CIN, CIN, CIN, nullptr);
      auto x0 = [&](int r, int c, float a) {
        return r < rows ? a + gt[(p0 + r < q.n_pcl ? 0 : C) + c0 + c] + q.b0[c0 + c] : 0.0f;
      };
      acc_store_rows(acc, x0b + static_cast<size_t>(p0) * C + c0, C, rows, x0);
      add_sums(acc, x0, t.red1, t.red2, t.s1, t.s2, c0);
    }
  }
  __syncthreads();
  finish_stats(t.s1, t.s2, t.mean0, t.inv0, P);
  __syncthreads();
  for (int i = tid; i < 2 * C; i += kThreads) t.s1[i] = 0.0f;

  // ---- (2) a = GELU(GN0(x0)) -> A, x2 = layer 1 -> X2, GN1 sums
  for (int p0 = 0; p0 < P; p0 += TM) {
    const int rows = min(TM, P - p0);
#pragma unroll 4
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ch = tid + k * F, g = ch / CPG;
        float a = 0.0f;
        if (r < rows) {
          const size_t e = static_cast<size_t>(p0 + r) * C + ch;
          a = gelu((x0b[e] - t.mean0[g]) * t.inv0[g] * q.gn0s[ch] + q.gn0b[ch]);
          actb[e] = a;
        }
        t.as[r * LDA + ch] = a;
      }
    }
    for (int h = 0; h < 2; ++h) {
      for (int c0 = 0; c0 < F; c0 += kTileN) {
        const int ch0 = h * F + c0;
        Acc<MI> acc;
        gemm_tile(acc, t.as + h * F, LDA, w1 + static_cast<size_t>(ch0) * F, F, F, nullptr);
        auto x2 = [&](int r, int c, float a) { return r < rows ? a + q.b1[ch0 + c] : 0.0f; };
        acc_store_rows(acc, x2b + static_cast<size_t>(p0) * C + ch0, C, rows, x2);
        add_sums(acc, x2, t.red1, t.red2, t.s1, t.s2, ch0);
      }
    }
  }
  __syncthreads();
  finish_stats(t.s1, t.s2, t.mean1, t.inv1, P);
  __syncthreads();

  // ---- (3) thread tid owns channels tid (head x) and tid + F (head y)
  {
    float v[2] = {0.0f, 0.0f}, sd[2] = {0.0f, 0.0f}, sdy[2] = {0.0f, 0.0f};
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ch = tid + k * F, g = ch / CPG;
        const float y = (x2b[static_cast<size_t>(p) * C + ch] - t.mean1[g]) * t.inv1[g];
        const float h1 = y * q.gn1s[ch] + q.gn1b[ch];
        const float w = q.pw[k * P + p];
        float act, dact;
        gelu_and_grad(h1, act, dact);
        v[k] += w * act;
        const float dh = w * t.dv[ch] * dact;
        sd[k] += dh;
        sdy[k] += dh * y;
      }
    }
    for (int k = 0; k < 2; ++k) {
      const int ch = tid + k * F;
      pobj[4 * C + ch] = sdy[k];   // d_gn1s
      pobj[5 * C + ch] = sd[k];    // d_gn1b
      t.s1[ch] = q.gn1s[ch] * sd[k];
      t.s2[ch] = q.gn1s[ch] * sdy[k];
      for (int j = 0; j < 3; ++j)
        q.pneck[(static_cast<size_t>(b) * 6 + 3 * k + j) * F + tid] = v[k] * dout[3 * k + j];
    }
  }
  backward_means(t.s1, t.s2, t.gm1, t.gm2, P);
  {
    // d_pw[h, p] = sum over the head's channels of GELU(h1) d_v, a warp per
    // point; lane owns channels lane + 32 j, h1 = x2 * scale + shift
    const int warp = tid / 32, lane = tid % 32;
    float scale[C / 32], shift[C / 32], dvl[C / 32];
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int ch = lane + 32 * j, g = ch / CPG;
      scale[j] = t.inv1[g] * q.gn1s[ch];
      shift[j] = q.gn1b[ch] - t.mean1[g] * scale[j];
      dvl[j] = t.dv[ch];
    }
    for (int p = warp; p < P; p += kThreads / 32) {
      float acc[2] = {0.0f, 0.0f};
      const float* row = x2b + static_cast<size_t>(p) * C + lane;
#pragma unroll
      for (int j = 0; j < C / 32; ++j) acc[j / (F / 32)] += gelu(row[32 * j] * scale[j] + shift[j]) * dvl[j];
      for (int off = 16; off > 0; off /= 2) {
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
        acc[1] += __shfl_xor_sync(0xffffffffu, acc[1], off);
      }
      if (lane == 0) {
        q.ppw[static_cast<size_t>(b) * 2 * P + p] = acc[0];
        q.ppw[static_cast<size_t>(b) * 2 * P + P + p] = acc[1];
      }
    }
  }

  // ---- (4) d_x2 -> D2, d_a = d_x2 W1 over X2's rows
  {
    float db1[2] = {0.0f, 0.0f};
    for (int p0 = 0; p0 < P; p0 += TM) {
      const int rows = min(TM, P - p0);
#pragma unroll 4
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int ch = tid + k * F, g = ch / CPG;
          float dx = 0.0f;
          if (r < rows) {
            const int p = p0 + r;
            const float y = (x2b[static_cast<size_t>(p) * C + ch] - t.mean1[g]) * t.inv1[g];
            const float dh = q.pw[k * P + p] * t.dv[ch] * gelu_grad(y * q.gn1s[ch] + q.gn1b[ch]);
            dx = t.inv1[g] * (dh * q.gn1s[ch] - t.gm1[g] - y * t.gm2[g]);
            db1[k] += dx;
          }
          t.as[r * LDA + ch] = dx;
          if (r < rows) d2b[static_cast<size_t>(p0 + r) * C + ch] = dx;
        }
      }
      for (int h = 0; h < 2; ++h) {
        for (int c0 = 0; c0 < F; c0 += kTileN) {
          const int ch0 = h * F + c0;
          Acc<MI> acc;
          gemm_tile(acc, t.as + h * F, LDA, w1t + static_cast<size_t>(ch0) * F, F, F, nullptr);
          acc_store_rows(acc, x2b + static_cast<size_t>(p0) * C + ch0, C, rows,
                         [](int, int, float a) { return a; });
        }
      }
    }
    for (int k = 0; k < 2; ++k) pobj[3 * C + tid + k * F] = db1[k];
  }
  __syncthreads();

  // ---- (5) GN0 backward sums, channel-owned
  {
    float sd[2] = {0.0f, 0.0f}, sdy[2] = {0.0f, 0.0f};
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ch = tid + k * F, g = ch / CPG;
        const size_t e = static_cast<size_t>(p) * C + ch;
        const float y = (x0b[e] - t.mean0[g]) * t.inv0[g];
        const float dh = x2b[e] * gelu_grad(y * q.gn0s[ch] + q.gn0b[ch]);   // d_h0
        sd[k] += dh;
        sdy[k] += dh * y;
      }
    }
    for (int k = 0; k < 2; ++k) {
      const int ch = tid + k * F;
      pobj[1 * C + ch] = sdy[k];   // d_gn0s
      pobj[2 * C + ch] = sd[k];    // d_gn0b
      t.s1[ch] = q.gn0s[ch] * sd[k];
      t.s2[ch] = q.gn0s[ch] * sdy[k];
    }
  }
  backward_means(t.s1, t.s2, t.gm1, t.gm2, P);

  // ---- (6) d_x0 -> D0, d_b0, d_gterm, d_pf = d_x0 W_pt
  {
    float db0[2] = {0.0f, 0.0f}, dg_pcl[2] = {0.0f, 0.0f}, dg_kps[2] = {0.0f, 0.0f};
    for (int p0 = 0; p0 < P; p0 += TM) {
      const int rows = min(TM, P - p0);
#pragma unroll 4
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int ch = tid + k * F, g = ch / CPG;
          float dx = 0.0f;
          if (r < rows) {
            const int p = p0 + r;
            const size_t e = static_cast<size_t>(p) * C + ch;
            const float y = (x0b[e] - t.mean0[g]) * t.inv0[g];
            const float dh = x2b[e] * gelu_grad(y * q.gn0s[ch] + q.gn0b[ch]);   // d_h0
            dx = t.inv0[g] * (dh * q.gn0s[ch] - t.gm1[g] - y * t.gm2[g]);
            db0[k] += dx;
            if (p < q.n_pcl) dg_pcl[k] += dx;
            else dg_kps[k] += dx;
          }
          t.as[r * LDA + ch] = dx;
          if (r < rows) d0b[static_cast<size_t>(p0 + r) * C + ch] = dx;
        }
      }
      Acc<MI> acc;
      gemm_tile(acc, t.as, LDA, w_pt_t, C, C, nullptr);
      acc_for_each(acc, [&](int r, int c, float a) {
        if (r < rows && c < CIN) q.d_pf[(obj + p0 + r) * CIN + c] = a;
      });
    }
    for (int k = 0; k < 2; ++k) {
      const int ch = tid + k * F;
      pobj[ch] = db0[k];
      q.d_gterm[static_cast<size_t>(b) * 2 * C + ch] = dg_pcl[k];
      q.d_gterm[static_cast<size_t>(b) * 2 * C + C + ch] = dg_kps[k];
    }
  }
}

int run(void* const* ptr, const Obj& q, int splits, void* stream) {
  auto f = [&](Slot s) { return static_cast<float*>(ptr[s]); };
  int err = launch(rot_head_bwd_f32, q.B, smem_bytes(), stream, static_cast<const float*>(f(PF)),
                   static_cast<const float*>(f(W_PT)), static_cast<const float*>(f(W1)),
                   static_cast<const float*>(f(W1T)), static_cast<const float*>(f(W_PT_T)),
                   f(ACT), f(D2), f(D0), q);
  if (err) return err;
  const long long K = static_cast<long long>(q.B) * q.P;
  err = product_tn<float>(f(D2), C, f(ACT), C, F, 2, F, F, K, splits, f(GPART), f(D_W1), stream);
  if (err) return err;
  return product_tn<float>(f(D0), C, f(PF), CIN, 0, 1, C, CIN, K, splits, f(GPART), f(D_W_PT),
                           stream);
}

}  // namespace exact

// The build's object kernel and weight-gradient products, then the
// per-object partials summed over objects.
int run(void* const* ptr, int B, int P, int n_pcl, int bf16, int splits, void* stream) {
  auto f = [&](Slot s) { return static_cast<float*>(ptr[s]); };
  Obj q;
  q.gterm = f(GTERM);
  q.dout = f(DOUT);
  q.b0 = f(B0);
  q.gn0s = f(GN0S);
  q.gn0b = f(GN0B);
  q.b1 = f(B1);
  q.gn1s = f(GN1S);
  q.gn1b = f(GN1B);
  q.pw = f(PW);
  q.neck = f(NECK);
  q.x0 = f(X0);
  q.x2 = f(X2);
  q.pfpart = f(PFPART);
  q.pobj = f(POBJ);
  q.ppw = f(PPW);
  q.pneck = f(PNECK);
  q.d_pf = f(D_PF);
  q.d_gterm = f(D_GTERM);
  q.B = B;
  q.P = P;
  q.n_pcl = n_pcl;
  int err = bf16 ? hopper::run(ptr, q, splits, stream) : exact::run(ptr, q, splits, stream);
  if (err) return err;
  const int sums[3][2] = {{POBJ, D_VEC}, {PPW, D_PW}, {PNECK, D_NECK}};
  const int widths[3] = {6 * C, 2 * P, 6 * F};
  for (int i = 0; i < 3; ++i) {
    err = launch(sum_rows, (widths[i] + kThreads - 1) / kThreads, 0, stream,
                 static_cast<const float*>(ptr[sums[i][0]]), static_cast<float*>(ptr[sums[i][1]]),
                 B, widths[i]);
    if (err) return err;
  }
  return 0;
}

}  // namespace

// ptr: kSlots device pointers in the order of Slot; pf, w_pt, w1, act, d2 and
// d0 hold T = bf16 if `bf16` else float (and w1t, w_pt_t for float), every
// other array f32.
extern "C" int catre_rot_head_bwd(void* const* ptr, int B, int P, int n_pcl, int bf16,
                                  int splits, void* stream) {
  return run(ptr, B, P, n_pcl, bf16, splits, stream);
}

extern "C" int catre_rot_head_bwd_slots() { return kSlots; }

// x (64, 256), w0 (256, 64), w1 (256, 256) bf16 -> out_w1 (64, 256) = x @ w1,
// out_wpt (64, 64) = x @ w0, out_l0 (64, 256) = x[:, :64] @ w0^T, f32: the
// products of K4 that read a staged weight transposed or by quarters (see
// hopper::wgmma_tn_kernel).
extern "C" int catre_wgmma_tn(const void* x, const void* w0, const void* w1, void* out_w1,
                              void* out_wpt, void* out_l0, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(hopper::wgmma_tn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(hopper::smem_bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  hopper::wgmma_tn_kernel<<<1, 128, hopper::smem_bytes(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const catre::bf16*>(x), static_cast<const catre::bf16*>(w0),
      static_cast<const catre::bf16*>(w1), static_cast<float*>(out_w1),
      static_cast<float*>(out_wpt), static_cast<float*>(out_l0));
  return static_cast<int>(cudaGetLastError());
}
