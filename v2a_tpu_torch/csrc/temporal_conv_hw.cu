// K11: K2's function on the HW-major view: x (S, B, F, C) -> y (S, B, F, C),
// y[s, b, f] = sum_t x[s, b, f + t - 1] @ W[t] + bias [+ emb[b]]
// [+ residual[s, b, f]], optionally with per-(B, F, C) sum / sum of squares
// of y over S.
//
// Replaces the TPU kernel `temporal_conv_fused_hw`
// (v2a_tpu/ops/resblock_kernels.py:340, body `_tconv_hw_kernel` :266).
//
// Frames are zero-padded on both sides (not causal). The taps are summed in
// float32, then bias, emb and the residual are added in that order in
// float32 and the sum is rounded to the input type once; the statistics are
// taken from the rounded values.
//
// What bounds it on the H100: memory (at S = 128^2, C = 128, B*F = 56 it
// moves ~0.35 GB for 1.6e10 FLOP). On the TPU the (S, B, F, C) view was a
// layout bitcast of the convs' operands; on the H100 it is a real tensor, so
// the wrapper's permutes into and out of it are copies (timed beside the
// kernel). Design: K2's implicit GEMM with the HW-major address map: a block
// owns 64 positions s of ONE (b, f) x 64 channels; row s of tap t is
// x[s, b, f + t - 1], C contiguous elements at a stride of B*F*C. The
// statistics leave each block as per-tile column sums, added in tile order
// by a second pass (deterministic, no atomics), where the TPU kernel
// accumulated them over its sequential grid.
#include "common.cuh"

namespace v2a {
namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
temporal_conv_hw_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ bias, const float* __restrict__ emb,
                        const T* __restrict__ res, T* __restrict__ y, float* __restrict__ partial,
                        int B, int F, int S, int C, int tiles) {
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int bf = blockIdx.x / tiles;  // (b, f) slab
  const int tile = blockIdx.x % tiles;
  const int b = bf / F, f = bf % F;
  const int s0 = tile * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const long row = (long)B * F * C;  // elements between s and s + 1

  Accum<T> acc;
  acc.zero();
  for (int t = 0; t < 3; ++t) {
    const int ff = f + t - 1;
    const bool frame_ok = ff >= 0 && ff < F;
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int k = 0; k < (BM * BK) / (THREADS * 8); ++k) {
        const int idx = tid + k * THREADS;
        const int r = idx / (BK / 8), cg = (idx % (BK / 8)) * 8;
        const int s = s0 + r;
        if (frame_ok && s < S)
          copy8(&As[r][cg], x + s * row + ((long)b * F + ff) * C + c0 + cg);
        else
          zero8(&As[r][cg]);  // the frame padding
      }
      load_b_tile<T>(Bs, w, (long)t * C + c0, C, n0);
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
      const long o = s * row + (long)bf * C + n0 + c;
      float v = Cs[r][c] + bias[n0 + c];
      if (emb) v += emb[(long)b * C + n0 + c];
      if (res) v += to_f(res[o]);
      const T rounded = from_f<T>(v);
      y[o] = rounded;
      q = to_f(rounded);
    }
    Cs[r][c] = q;  // rows past S count as zero in the statistics
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
                   const void* res, void* y, void* partial, void* stats, int B, int F, int S,
                   int C, cudaStream_t stream) {
  const int tiles = (S + BM - 1) / BM;
  dim3 grid((unsigned)(B * F * tiles), (unsigned)(C / BN));
  temporal_conv_hw_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(emb), static_cast<const T*>(res), static_cast<T*>(y),
      static_cast<float*>(partial), B, F, S, C, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !partial) return err;
  return reduce_tiles(static_cast<const float*>(partial), static_cast<float*>(stats),
                      (long)B * F, C, tiles, stream);
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. x, res, y (S, B, F, C); w (3 C, C)
// tap-major; bias (C) and emb (B, C) float32. emb, res, partial / stats may
// be null; partial holds B*F*ceil(S/64)*2*C floats, stats (B, F, 2, C).
// Needs C % 64 == 0, 16-byte aligned contiguous buffers.
extern "C" int v2a_temporal_conv_hw(const void* x, const void* w, const void* bias,
                                    const void* emb, const void* res, void* y, void* partial,
                                    void* stats, int B, int F, int S, int C, int dtype,
                                    void* stream) {
  if (B <= 0 || F <= 0 || S <= 0 || C <= 0 || C % v2a::BN || C % v2a::BK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::launch<__nv_bfloat16>(x, w, bias, emb, res, y, partial, stats, B, F, S, C,
                                           s);
  if (dtype == 0)
    return (int)v2a::launch<float>(x, w, bias, emb, res, y, partial, stats, B, F, S, C, s);
  return (int)cudaErrorInvalidValue;
}
