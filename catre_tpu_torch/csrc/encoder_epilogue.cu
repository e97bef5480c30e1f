// PointNet encoder tails: dense (+ReLU +dense) fused with the per-cloud max.
//
// Replaces the Pallas kernels of catre_tpu/ops/pallas_encoder_epilogue.py:
//   K1 fused_dense_relu_dense_max (:98, body _kernel_2 :51)
//        out[n, c] = max_p ( relu(x[n, p] @ W3^T + b3) @ W4^T + b4 )[c]
//        the main conv3 -> conv4 -> max tail, x (2B, 1024, 128), 128->512->1024;
//   K2 fused_dense_relu_max (:89, body _kernel_1 :41)
//        out[n, c] = max_p relu(x[n, p] @ W^T + b)[c]
//        the STN3d / STNkd conv3 tails, 128 -> 1024.
// Rounding follows flax Dense(dtype=T): each product is accumulated in f32
// and rounded to T, the T bias is added and the sum rounded to T, then ReLU;
// the max is returned in f32. T is bf16 (production) or f32 (checks).
//
// What bounds it on the card: arithmetic. Per point K1 does 2*(128*512 +
// 512*1024) = 1.18 MFLOP on 256 input bytes (bf16), K2 262 KFLOP, far above
// the H100's ~295 FLOP/byte ridge. Unfused, the (2B*1024, 1024) conv4
// activation would be written and read back: 16 GB in bf16 at B = 4096.
//
// The f32 builds of K1 and K2 are in encoder_epilogue.cuh, shared with the
// training forwards K5/K6 (encoder_epilogue_train.cu); here they run without
// the argmax. The bf16 builds, the production ones, take the max on the bare
// accumulator: K1's is encoder_tail_wgmma.cuh (wgmma, the hidden tile in
// shared memory), K2's encoder_stn_tail_wgmma.cuh (wgmma, persistent blocks
// that keep their slice of W in shared memory); with kIdx the same two are
// the bf16 training forwards K6 and K5.
#include "encoder_epilogue.cuh"
#include "encoder_stn_tail_wgmma.cuh"
#include "encoder_tail_wgmma.cuh"

using namespace catre;

// x (n, p, cin) and w (cout, cin) in T = bf16 if `bf16` else f32; b (cout) f32,
// already rounded to T; out (n, cout) f32. cin % 64 == 0, cout % 128 == 0. In
// bf16, cin is 64 or 128 and `grid` is the number of persistent blocks
// (ops/encoder_epilogue.py::stn_tail_grid); f32 launches a block per cloud.
extern "C" int catre_dense_relu_max(const void* x, const void* w, const void* b, void* out, int n,
                                    int p, int cin, int cout, int bf16, int grid, void* stream) {
  const MaxOut<false> o{static_cast<float*>(out)};
  if (bf16) return stn::run<stn::kChunks>(x, w, b, o, n, p, cin, cout, grid, stream);
  return enc::run_relu_max<false>(x, w, b, o, n, p, cin, cout, stream);
}

// What the bf16 K2 keeps per block: its 128-channel chunks (the wrapper's
// schedule needs them) and its dynamic shared memory in bytes at cin = 128.
extern "C" int catre_stn_tail_chunks() { return stn::kChunks; }
extern "C" int catre_stn_tail_smem() { return static_cast<int>(stn::smem_bytes<8, stn::kChunks>()); }

// x (n, p, cin), w3 (chid, cin), w4 (cout, chid) in T; b3, b4 f32 rounded to
// T; out (n, cout) f32. cin % 64 == 0, chid and cout % 128 == 0. In bf16, w3
// and w4 come repacked as 128-row x 64-column swizzled panels in the order
// the kernel streams them (ops/encoder_epilogue.py::pack_panels), cin is 64
// or 128 and chid at most 512.
extern "C" int catre_dense_relu_dense_max(const void* x, const void* w3, const void* b3,
                                          const void* w4, const void* b4, void* out, int n, int p,
                                          int cin, int chid, int cout, int bf16, void* stream) {
  const MaxOut<false> o{static_cast<float*>(out)};
  if (bf16) return tail::run(x, w3, b3, w4, b4, o, n, p, cin, chid, cout, stream);
  return enc::run_relu_dense_max<false>(x, w3, b3, w4, b4, o, n, p, cin, chid, cout, stream);
}
