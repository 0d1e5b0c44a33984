// K1: y = conv3x3_same(act(x)) + bias on (N, H, W, C) -> (N, H, W, D).
//
// Replaces the TPU kernel `fused_affine_conv3x3`
// (v2a_tpu/ops/resblock_kernels.py:662, bodies `_affine_conv_kernel` :489 and
// `_affine_conv_banded_kernel` :554).
//
// act(x) = silu(a[n, c] * x + b[n, c]) (mode 2), a[n, c] * x + b[n, c]
// (mode 1) or x (mode 0, plain conv), computed in float32 and rounded to the
// input type before the product, as the TPU kernel does. The SAME halo is
// zero AFTER the activation: the gather writes 0 for every tap that falls
// outside the frame instead of activating a zero pad.
//
// What bounds it on the H100: at the release shapes it is compute-bound
// (128^2 x 128 -> 128 at N = 56 is 2.7e11 FLOP against ~0.24 GB of traffic).
// Design: an implicit GEMM, M = N*H*W pixels, K = 9*C (tap-major, the
// TPU's di*3+dj order), N = D. A block owns a 64-pixel x 64-channel output
// tile; per (tap, 32-channel) step it gathers the shifted, activated input
// rows into shared memory and multiplies them with the matching weight slab
// on the tensor cores (wmma bf16, float32 accumulators). The activation is
// recomputed per tap instead of being stored, so the normed tensor never
// reaches device memory. One kernel covers both TPU bodies: the whole-frame
// / row-band split there is a VMEM tiling, and 64-pixel tiles fit shared
// memory at every level.
#include "common.cuh"

namespace v2a {
namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
affine_conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ b, const T* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ y, int N, int H,
                      int W, int C, int D, int mode) {
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const long M = (long)N * H * W;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // each thread gathers the same two output rows for the whole K loop
  constexpr int SLOTS = (BM * BK) / (THREADS * 8);
  int rrow[SLOTS], rcg[SLOTS], rn[SLOTS], rh[SLOTS], rw[SLOTS];
  bool rvalid[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    int idx = tid + s * THREADS;
    rrow[s] = idx / (BK / 8);
    rcg[s] = (idx % (BK / 8)) * 8;
    long m = m0 + rrow[s];
    rvalid[s] = m < M;
    long mm = rvalid[s] ? m : 0;
    rn[s] = (int)(mm / ((long)H * W));
    int rem = (int)(mm % ((long)H * W));
    rh[s] = rem / W;
    rw[s] = rem % W;
  }

  Accum<T> acc;
  acc.zero();
  for (int tap = 0; tap < 9; ++tap) {
    const int di = tap / 3 - 1, dj = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int hh = rh[s] + di, ww = rw[s] + dj;
        T* dst = &As[rrow[s]][rcg[s]];
        if (!rvalid[s] || hh < 0 || hh >= H || ww < 0 || ww >= W) {
          zero8(dst);  // the halo is zero after the activation
          continue;
        }
        const long off = (((long)rn[s] * H + hh) * W + ww) * C + c0 + rcg[s];
        if (mode == 0) {
          copy8(dst, x + off);
          continue;
        }
        float v[8];
        load8(x + off, v);
        const long aoff = (long)rn[s] * C + c0 + rcg[s];
        affine8(v, a + aoff, b + aoff, mode == 2);
        store8(dst, v);  // rounded to T before the product
      }
      load_b_tile<T>(Bs, w, (long)tap * C + c0, D, n0);
      __syncthreads();
      acc.step(As, Bs);
      __syncthreads();
    }
  }
  acc.store(Cs);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const long m = m0 + r;
    if (m < M) y[m * D + n0 + c] = from_f<T>(Cs[r][c] + bias[n0 + c]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b, const void* w, const void* bias,
                   void* y, int N, int H, int W, int C, int D, int mode, cudaStream_t stream) {
  const long M = (long)N * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(D / BN));
  affine_conv3x3_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const T*>(w), static_cast<const float*>(bias), static_cast<T*>(y), N, H, W,
      C, D, mode);
  return cudaGetLastError();
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. mode: 0 plain conv, 1 affine, 2 affine+SiLU.
// Needs C % 32 == 0, D % 64 == 0, 16-byte aligned contiguous buffers.
extern "C" int v2a_affine_conv3x3(const void* x, const void* a, const void* b, const void* w,
                                  const void* bias, void* y, int N, int H, int W, int C, int D,
                                  int mode, int dtype, void* stream) {
  if (C % v2a::BK || D % v2a::BN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::launch<__nv_bfloat16>(x, a, b, w, bias, y, N, H, W, C, D, mode, s);
  if (dtype == 0) return (int)v2a::launch<float>(x, a, b, w, bias, y, N, H, W, C, D, mode, s);
  return (int)cudaErrorInvalidValue;
}
