// K3: the whole padded-stream PseudoConv3d in one kernel: K4a (a multi-part
// affine+SiLU 3x3 conv) and then K4b (the 3-tap temporal conv with emb,
// residual, the folded 1x1 skip projection and the statistics), on
// (B, F, H+2, Wp, C_i) streams -> (B, F, H+2, Wp, D).
//
// Replaces the TPU kernel `fused_conv_tconv_padded`
// (v2a_tpu/ops/resblock_kernels.py:1978, body `_conv_tconv_kernel` :1592).
//
// What bounds it on the H100: operations (PERF.md: 6.99 ms of bound per B=8
// release forward over its 16 calls; at 128^2, 128 -> 128 with the
// residual, B = 8: 2.7e11 FLOP of conv taps and 9.0e10 of temporal taps
// against ~0.76 GB). Design: the shared mainloop of conv_tconv_hopper.cuh.
// A cluster of D / NC CTAs owns P pixels of one sample for ALL F frames;
// each CTA computes its NC conv channels of every frame into shared memory
// (rounded to bf16, never stored to device memory on the model's path),
// then, after a cluster barrier, the temporal GEMM (K = 3 D, the other
// ranks' slices read through distributed shared memory) plus the skip
// parts' K steps, and writes y and per-tile statistics.
#include "conv_tconv_hopper.cuh"

namespace v2a {
namespace {

using hop::bf16;

template <int P, int NC>
__global__ void __launch_bounds__(hop::THREADS)
conv_tconv_padded_kernel(const __grid_constant__ hop::Args<bf16> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  hop::Mainloop<P, NC> m(a, smem, a.F);
  m.conv_frames(0, a.F, 0);
  m.cl.sync();  // every rank's conv half before any temporal read
  m.tconv_frames(0, a.F, 0);
  m.cl.sync();  // no rank leaves while another reads its slots
}

struct K3 {
  template <int P, int NC>
  static void (*fn())(hop::Args<bf16>) {
    return conv_tconv_padded_kernel<P, NC>;
  }
};

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. Part i: x_i (B, F, H+2, Wp, C_i), a_i / b_i
// (B*F, C_i) float32, w_i (9 C_i, D); C1 = 0 (null pointers) for one part.
// kbias, tbias (D) float32; tw (3 D, D); emb (B, D) float32; res (B, F, H+2,
// Wp, D); skip part i: s_i (B, F, H+2, Wp, Cs_i), k_i (Cs_i, D), sbias (D)
// float32 with any skip part. conv_out (like y): the rounded conv half's
// interior, or null (float32 needs it: its conv half goes through it).
// emb, res, skips, partial / stats may be null; partial holds
// B*F*tiles*2*D floats, stats B*F*2*D (tiles: `hop::tile_of`). P: pixels per
// tile, 16, 32 or 64 (the tile plan). Needs C_i % 32 == 0, Cs_i % 32 == 0,
// D % 64 == 0 with D / NC <= 8, Wp % 8 == 0, 16-byte aligned buffers.
extern "C" int v2a_conv_tconv_padded(const void* x0, const void* a0, const void* b0,
                                     const void* w0, const void* x1, const void* a1,
                                     const void* b1, const void* w1, const void* kbias,
                                     const void* tw, const void* tbias, const void* emb,
                                     const void* res, const void* s0, const void* k0,
                                     const void* s1, const void* k1, const void* sbias, void* y,
                                     void* conv_out, void* partial, void* stats, int B, int F,
                                     int H, int W, int Wp, int C0, int C1, int D, int Cs0,
                                     int Cs1, int P, int silu, int dtype, void* stream) {
  const int bad = v2a::hop::check(B, F, H, W, Wp, C0, C1, D, Cs0, Cs1, P, dtype, conv_out,
                                  partial, stats, sbias);
  if (bad) return bad;
  const void* pa[8] = {x0, a0, b0, w0, x1, a1, b1, w1};
  const int C[2] = {C0, C1};
  const void* sk[4] = {s0, k0, s1, k1};
  const int Cs[2] = {Cs0, Cs1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::hop::launch_bf16<v2a::K3>(
        v2a::hop::args_from<__nv_bfloat16>(pa, C, sk, Cs, kbias, tw, tbias, emb, res, sbias, y,
                                           conv_out, partial, B, F, H, W, Wp, D, silu),
        P, F, static_cast<float*>(stats), s);
  return (int)v2a::hop::launch_f32(
      v2a::hop::args_from<float>(pa, C, sk, Cs, kbias, tw, tbias, emb, res, sbias, y, conv_out,
                                 partial, B, F, H, W, Wp, D, silu),
      P, static_cast<float*>(stats), s);
}
