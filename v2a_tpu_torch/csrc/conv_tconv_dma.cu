// K13: K3's function (the padded-stream PseudoConv3d: a multi-part
// affine+SiLU 3x3 conv, its output rounded, then the 3-tap temporal conv with
// emb, residual, the folded 1x1 skip projection and the statistics) with its
// copies issued by the Tensor Memory Accelerator, on (B, F, H+2, Wp, C_i)
// streams -> (B, F, H+2, Wp, D).
//
// Replaces the TPU kernel `fused_conv_tconv_dma`
// (v2a_tpu/ops/resblock_kernels.py:2377, body `_conv_tconv_dma_kernel`
// :2152), which is K3 with hand-made double-buffered DMA: band i+1's windows
// load while band i computes. It differs from K3 in its copies only.
//
// What bounds it on the H100: operations, as K3 (6.99 ms of bound per B=8
// release forward over K3's 16 calls). Design: K3's kernel on the shared
// mainloop of conv_tconv_hopper.cuh, with the copy policy `Copy::tma`, the
// Hopper counterpart of the TPU kernel's manual DMA: one thread issues each
// window (a 4-D box of the padded stream, 64-byte swizzle, which is the
// mainloop's `row64`) with its chunk's a, b (bulk copies) and each weight
// slab (2-D boxes of 32 rows x 64 columns, 128-byte swizzle), each ring
// stage completing on its own mbarrier, where K3's 256 threads issue
// 16-byte cp.async copies. The rings keep K3's depth (3 stages), so the two
// kernels differ in the copy engine alone. The box brings the pad rows and
// cols too (pad rows may hold NaN); the activation selects every position
// outside the interior to zero, as it does for K3. The products, their
// order, the tile plan (`conv_tconv_plan`) and the statistics are K3's, so
// K13 is bit-equal to K3. float32 (tests only) takes K3's two plain passes.
#include "conv_tconv_hopper.cuh"

namespace v2a {
namespace {

using hop::bf16;

template <int P, int NC>
__global__ void __launch_bounds__(hop::THREADS)
conv_tconv_dma_kernel(const __grid_constant__ hop::Args<bf16> a,
                      const __grid_constant__ hop::Maps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  hop::Mainloop<P, NC, hop::Copy::tma> m(a, smem, a.F, &maps);
  m.conv_frames(0, a.F, 0);
  m.cl.sync();  // every rank's conv half before any temporal read
  m.tconv_frames(0, a.F, 0);
  m.cl.sync();  // no rank leaves while another reads its slots
}

struct K13 {
  template <int P, int NC>
  static void (*fn())(hop::Args<bf16>, hop::Maps) {
    return conv_tconv_dma_kernel<P, NC>;
  }
};

}  // namespace
}  // namespace v2a

// K3's interface (`v2a_conv_tconv_padded`): dtype: 0 = float32, 1 = bfloat16.
// Part i: x_i (B, F, H+2, Wp, C_i), a_i / b_i (B*F, C_i) float32, w_i (9 C_i,
// D); C1 = 0 (null pointers) for one part. kbias, tbias (D) float32; tw (3 D,
// D); emb (B, D) float32; res (B, F, H+2, Wp, D); skip part i: s_i (B, F,
// H+2, Wp, Cs_i), k_i (Cs_i, D), sbias (D) float32 with any skip part.
// conv_out (like y): the rounded conv half's interior, or null (float32
// needs it). emb, res, skips, partial / stats may be null; partial holds
// B*F*tiles*2*D floats, stats B*F*2*D. P: pixels per tile, 16, 32 or 64
// (the tile plan). Needs C_i % 32 == 0, Cs_i % 32 == 0, D % 64 == 0 with
// D / NC <= 8, Wp % 8 == 0, 16-byte aligned buffers.
extern "C" int v2a_conv_tconv_dma(const void* x0, const void* a0, const void* b0, const void* w0,
                                  const void* x1, const void* a1, const void* b1, const void* w1,
                                  const void* kbias, const void* tw, const void* tbias,
                                  const void* emb, const void* res, const void* s0,
                                  const void* k0, const void* s1, const void* k1,
                                  const void* sbias, void* y, void* conv_out, void* partial,
                                  void* stats, int B, int F, int H, int W, int Wp, int C0, int C1,
                                  int D, int Cs0, int Cs1, int P, int silu, int dtype,
                                  void* stream) {
  const int bad = v2a::hop::check(B, F, H, W, Wp, C0, C1, D, Cs0, Cs1, P, dtype, conv_out,
                                  partial, stats, sbias);
  if (bad) return bad;
  const void* pa[8] = {x0, a0, b0, w0, x1, a1, b1, w1};
  const int C[2] = {C0, C1};
  const void* sk[4] = {s0, k0, s1, k1};
  const int Cs[2] = {Cs0, Cs1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::hop::launch_bf16<v2a::K13, v2a::hop::Copy::tma>(
        v2a::hop::args_from<__nv_bfloat16>(pa, C, sk, Cs, kbias, tw, tbias, emb, res, sbias, y,
                                           conv_out, partial, B, F, H, W, Wp, D, silu),
        P, F, static_cast<float*>(stats), s);
  return (int)v2a::hop::launch_f32(
      v2a::hop::args_from<float>(pa, C, sk, Cs, kbias, tw, tbias, emb, res, sbias, y, conv_out,
                                 partial, B, F, H, W, Wp, D, silu),
      P, static_cast<float*>(stats), s);
}
