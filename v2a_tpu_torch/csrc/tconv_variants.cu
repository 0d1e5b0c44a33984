// K15: the perf lab's plain temporal conv, y[b, f, s] = sum_t x[b, f + t - 1, s]
// @ W_t on (B, F, S, C) -> (B, F, S, C), frames zero-padded on both sides, the
// three taps summed in float32 and rounded once; no bias.
//
// Replaces the TPU kernel of the JAX perf lab's `tconvbench2`
// (scripts/perf_lab.py:627 `tconv_variants_bench.make_call`, body `kernel`
// :628-671, its pallas_call :674). The TPU kernel has three schedules
// (`frame_concat`, `all_frames`, `taps`), tiling experiments that compute
// the same function; this is one kernel.
//
// What bounds it on the H100: bytes at C = 128 (8x7x16384x128: 3.3e10 FLOP
// against 0.24 GB, 0.033 against 0.070 ms), operations from C = 256 on.
// Design: K2's (csrc/temporal_conv.cu) implicit GEMM over rows (b, f, s)
// with K = 3 C, tap-major: a block owns 64 positions of one (b, f) slab x 64
// channels, the frame padding is zero cells of the A tile, and the epilogue
// only rounds.
#include "common.cuh"

namespace v2a {
namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
tconv_taps_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int F,
                  int S, int C, int tiles) {
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int bf = blockIdx.x / tiles;  // (b, f) slab
  const int tile = blockIdx.x % tiles;
  const int b = bf / F, f = bf % F;
  const int s0 = tile * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

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
          copy8(&As[r][cg], x + (((long)b * F + ff) * S + s) * C + c0 + cg);
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
    if (s < S) y[((long)bf * S + s) * C + n0 + c] = from_f<T>(Cs[r][c]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int B, int F, int S, int C,
                   cudaStream_t stream) {
  const int tiles = (S + BM - 1) / BM;
  dim3 grid((unsigned)(B * F * tiles), (unsigned)(C / BN));
  tconv_taps_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x),
                                                     static_cast<const T*>(w),
                                                     static_cast<T*>(y), F, S, C, tiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. x, y (B, F, S, C); w (3 C, C), tap-major
// (rows t*C .. t*C + C - 1 multiply frame f + t - 1). Needs C % 64 == 0,
// 16-byte aligned contiguous buffers.
extern "C" int v2a_tconv_variants(const void* x, const void* w, void* y, int B, int F, int S,
                                  int C, int dtype, void* stream) {
  if (B <= 0 || F <= 0 || S <= 0 || C <= 0 || C % v2a::BN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)v2a::launch<__nv_bfloat16>(x, w, y, B, F, S, C, s);
  if (dtype == 0) return (int)v2a::launch<float>(x, w, y, B, F, S, C, s);
  return (int)cudaErrorInvalidValue;
}
