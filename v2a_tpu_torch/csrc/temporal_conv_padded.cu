// K4b: the 3-tap temporal conv over a padded stream (B, F, H+2, Wp, C), with
// the ResBlock's 1x1 skip projection folded in, optionally with per-(B, F, C)
// sum / sum of squares of the rounded interior.
//
// Replaces the TPU kernel `temporal_conv_padded`
// (v2a_tpu/ops/resblock_kernels.py:1090, body `_tconv_padded_kernel` :983).
//
// On every interior position (rows 1..H, cols 1..W):
//   y = sum_t x[f + t - 1] @ W[t]            (frames zero-padded both sides)
//       + (bias + emb[b]) + sum_s x_s @ K_s + skip_bias + residual
// in float32, rounded once to the input type. Pad cols of y are written as
// zeros; pad rows are neither read nor written. The statistics come from
// the rounded interior values.
//
// What bounds it on the H100: operations, narrowly: each pixel of a frame
// takes ~2.7 C x C taps (3F-2 of them over F frames), so from C = 256 on the
// products outweigh the bytes (at 128^2 x 256 after the last upsample,
// B*F = 56: 3.3e11 FLOP, 0.33 ms, against ~0.97 GB, 0.29 ms). Design: K2's implicit
// GEMM over interior positions of one (b, f) slab with the padded address
// map; the skip parts are further K segments (x_s at frame f against K_s)
// of the same float32 accumulator, so the projected residual never exists in
// device memory. The TPU summed the statistics along a sequential grid axis;
// here each block writes the column sums of its tile and a second pass adds
// them in tile order (deterministic, no atomics).
#include "common.cuh"

namespace v2a {
namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
tconv_padded_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ emb,
                    const T* __restrict__ res, Skip<T> q0, Skip<T> q1,
                    const float* __restrict__ sbias, T* __restrict__ y,
                    float* __restrict__ partial, int F, int H, int W, int Wp, int C, int tiles) {
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int bf = blockIdx.x / tiles;  // (b, f) slab
  const int tile = blockIdx.x % tiles;
  const int b = bf / F, f = bf % F;
  const int S = H * W;
  const int s0 = tile * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const long frame = (long)(H + 2) * Wp;  // positions per padded frame

  // each thread gathers the same two positions for the whole K loop
  constexpr int SLOTS = (BM * BK) / (THREADS * 8);
  int rrow[SLOTS], rcg[SLOTS];
  long rpos[SLOTS];  // padded position within a frame, -1 past the interior
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int idx = tid + k * THREADS;
    rrow[k] = idx / (BK / 8);
    rcg[k] = (idx % (BK / 8)) * 8;
    const int s = s0 + rrow[k];
    rpos[k] = s < S ? (long)(s / W + 1) * Wp + s % W + 1 : -1;
  }

  Accum<T> acc;
  acc.zero();
  for (int t = 0; t < 3; ++t) {
    const int ff = f + t - 1;
    const bool frame_ok = ff >= 0 && ff < F;
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        if (frame_ok && rpos[k] >= 0)
          copy8(&As[rrow[k]][rcg[k]],
                x + (((long)b * F + ff) * frame + rpos[k]) * C + c0 + rcg[k]);
        else
          zero8(&As[rrow[k]][rcg[k]]);  // the frame padding
      }
      load_b_tile<T>(Bs, w, (long)t * C + c0, C, n0);
      __syncthreads();
      acc.step(As, Bs);
      __syncthreads();
    }
  }
  for (int part = 0; part < 2; ++part) {
    const Skip<T> q = part ? q1 : q0;
    for (int c0 = 0; c0 < q.C; c0 += BK) {
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        if (rpos[k] >= 0)
          copy8(&As[rrow[k]][rcg[k]], q.x + ((long)bf * frame + rpos[k]) * q.C + c0 + rcg[k]);
        else
          zero8(&As[rrow[k]][rcg[k]]);
      }
      load_b_tile<T>(Bs, q.k, c0, C, n0);
      __syncthreads();
      acc.step(As, Bs);
      __syncthreads();
    }
  }
  acc.store(Cs);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int s = s0 + r;
    float q = 0.f;
    if (s < S) {
      const int h = s / W, ww = s % W;
      const long o = ((long)bf * frame + (long)(h + 1) * Wp + ww + 1) * C + n0 + c;
      float off = bias[n0 + c];
      if (emb) off += emb[(long)b * C + n0 + c];
      float v = Cs[r][c] + off;
      if (sbias) v += sbias[n0 + c];
      if (res) v += to_f(res[o]);
      const T rounded = from_f<T>(v);
      y[o] = rounded;
      zero_pad_cols(y, o, ww, W, Wp, C);
      q = to_f(rounded);
    }
    Cs[r][c] = q;  // positions past the interior count as zero in the statistics
  }
  if (!partial) return;
  __syncthreads();
  const int col = tid % BN, which = tid / BN;  // 0: sum, 1: sum of squares
  float sum = 0.f;
  for (int r = 0; r < BM; ++r) {
    const float v = Cs[r][col];
    sum += which ? v * v : v;
  }
  partial[(((long)bf * tiles + tile) * 2 + which) * C + n0 + col] = sum;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* emb,
                   const void* res, const void* const* sk, const int* Cs, const void* sbias,
                   void* y, void* partial, void* stats, int B, int F, int H, int W, int Wp, int C,
                   cudaStream_t stream) {
  Skip<T> q[2];
  skips_from(sk, Cs, q);
  const int tiles = (H * W + BM - 1) / BM;
  dim3 grid((unsigned)(B * F * tiles), (unsigned)(C / BN));
  tconv_padded_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(emb), static_cast<const T*>(res), q[0], q[1],
      static_cast<const float*>(sbias), static_cast<T*>(y), static_cast<float*>(partial), F, H,
      W, Wp, C, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !partial) return err;
  return reduce_tiles(static_cast<const float*>(partial), static_cast<float*>(stats),
                      (long)B * F, C, tiles, stream);
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. x, res (B, F, H+2, Wp, C); w (3 C, C);
// bias (C) and emb (B, C) float32; skip part i: s_i (B, F, H+2, Wp, Cs_i),
// k_i (Cs_i, C), Cs_i = 0 (null pointers) when absent; sbias (C) float32 with
// any skip part. emb, res, sbias, partial / stats may be null; partial holds
// B*F*ceil(H*W/64)*2*C floats, stats B*F*2*C. Needs C % 64 == 0,
// Cs_i % 32 == 0, Wp % 8 == 0, 16-byte aligned buffers.
extern "C" int v2a_temporal_conv_padded(const void* x, const void* w, const void* bias,
                                        const void* emb, const void* res, const void* s0,
                                        const void* k0, const void* s1, const void* k1,
                                        const void* sbias, void* y, void* partial, void* stats,
                                        int B, int F, int H, int W, int Wp, int C, int Cs0,
                                        int Cs1, int dtype, void* stream) {
  if (C % v2a::BN || Cs0 % v2a::BK || Cs1 % v2a::BK || Wp % 8 || Wp < W + 2)
    return (int)cudaErrorInvalidValue;
  if ((Cs0 || Cs1) && !sbias) return (int)cudaErrorInvalidValue;
  const void* sk[4] = {s0, k0, s1, k1};
  const int Cs[2] = {Cs0, Cs1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::launch<__nv_bfloat16>(x, w, bias, emb, res, sk, Cs, sbias, y, partial, stats,
                                           B, F, H, W, Wp, C, s);
  if (dtype == 0)
    return (int)v2a::launch<float>(x, w, bias, emb, res, sk, Cs, sbias, y, partial, stats, B, F,
                                   H, W, Wp, C, s);
  return (int)cudaErrorInvalidValue;
}
