// K12: the padded-stream PseudoConv3d with frames streamed through a 3-slot
// ring: K3's function without the skip fold. Parts x_i (B, F, H+2, Wp, C_i)
// -> y (B, F, H+2, Wp, D).
//
// Replaces the TPU kernel `fused_conv_tconv_stream`
// (v2a_tpu/ops/resblock_kernels.py:2656, body `_conv_tconv_stream_kernel`
// :2503).
//
// What bounds it on the H100: operations (PERF.md: 7.89 ms of bound per B=8
// release forward over its 19 calls; at 64^2, 256 -> 256, B = 8: 2.6e11
// FLOP of conv taps and 8.8e10 of temporal taps against ~0.3 GB). Design:
// the shared mainloop of conv_tconv_hopper.cuh, with the TPU kernel's
// frame order: a cluster of D / NC CTAs owns P pixels of one sample and
// walks f = 0..F; each CTA convolves frame f into ring slot f % 3 (its NC
// channels, rounded), and after a cluster barrier runs frame f - 1's
// temporal GEMM out of the three slots of every rank (a missing neighbour
// selected to zero); a second barrier keeps slot (f + 1) % 3 from being
// overwritten while another rank still reads it. The ring holds 3 frames
// where K3 holds all F, so the tile plan can shrink P at B = 1 until the
// grid has a CTA per SM.
#include "conv_tconv_hopper.cuh"

namespace v2a {
namespace {

using hop::bf16;

template <int P, int NC>
__global__ void __launch_bounds__(hop::THREADS)
conv_tconv_stream_kernel(const __grid_constant__ hop::Args<bf16> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  hop::Mainloop<P, NC> m(a, smem, 3);
  for (int f = 0; f <= a.F; ++f) {
    if (f < a.F) m.conv_frames(f, 1, 3);
    m.cl.sync();  // every rank's slot f before the reads
    if (f < 1) continue;
    m.tconv_frames(f - 1, 1, 3);
    m.cl.sync();  // every read of slot f - 2 before it is overwritten (or the CTA leaves)
  }
}

struct K12 {
  template <int P, int NC>
  static void (*fn())(hop::Args<bf16>) {
    return conv_tconv_stream_kernel<P, NC>;
  }
};

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. Part i: x_i (B, F, H+2, Wp, C_i), a_i / b_i
// (B*F, C_i) float32, w_i (9 C_i, D); C1 = 0 (null pointers) for one part.
// kbias, tbias (D) float32; tw (3 D, D); emb (B, D) float32; res (B, F, H+2,
// Wp, D). conv_out (like y): the rounded conv half's interior, or null
// (float32 needs it). emb, res, partial / stats may be null; partial holds
// B*F*tiles*2*D floats, stats B*F*2*D (tiles: `hop::tile_of`). P: pixels per
// tile, 16, 32 or 64 (the tile plan). Needs C_i % 32 == 0, D % 64 == 0 with
// D / NC <= 8, Wp % 8 == 0, 16-byte aligned buffers.
extern "C" int v2a_conv_tconv_stream(const void* x0, const void* a0, const void* b0,
                                     const void* w0, const void* x1, const void* a1,
                                     const void* b1, const void* w1, const void* kbias,
                                     const void* tw, const void* tbias, const void* emb,
                                     const void* res, void* y, void* conv_out, void* partial,
                                     void* stats, int B, int F, int H, int W, int Wp, int C0,
                                     int C1, int D, int P, int silu, int dtype, void* stream) {
  const int bad = v2a::hop::check(B, F, H, W, Wp, C0, C1, D, 0, 0, P, dtype, conv_out, partial,
                                  stats, nullptr);
  if (bad) return bad;
  const void* pa[8] = {x0, a0, b0, w0, x1, a1, b1, w1};
  const int C[2] = {C0, C1};
  const void* sk[4] = {nullptr, nullptr, nullptr, nullptr};
  const int Cs[2] = {0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::hop::launch_bf16<v2a::K12>(
        v2a::hop::args_from<__nv_bfloat16>(pa, C, sk, Cs, kbias, tw, tbias, emb, res, nullptr, y,
                                           conv_out, partial, B, F, H, W, Wp, D, silu),
        P, 3, static_cast<float*>(stats), s);
  return (int)v2a::hop::launch_f32(
      v2a::hop::args_from<float>(pa, C, sk, Cs, kbias, tw, tbias, emb, res, nullptr, y, conv_out,
                                 partial, B, F, H, W, Wp, D, silu),
      P, static_cast<float*>(stats), s);
}
