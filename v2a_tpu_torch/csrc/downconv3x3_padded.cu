// K8: y = conv3x3_stride2_same(act(x)) + bias between padded streams,
// x (N, H+2, Wp, C) at the full size -> y (N, H/2+2, Wp2, D) at half the size.
//
// Replaces the TPU kernel `fused_downconv3x3_padded`
// (v2a_tpu/ops/resblock_kernels.py:1514, body `_downconv_kernel` :1413).
//
// act(x) = silu(a[n, c] * x + b[n, c]) (mode 2), the affine alone (mode 1) or
// x itself (mode 0), in float32 and rounded to the input type as K1 computes
// it (`affine8`). Output interior pixel (i, j) reads padded input (2i + di,
// 2j + dj), di, dj in 0..2: the SAME conv with a (1, 1) halo. A tap outside
// the input interior contributes zero AFTER the activation and is never
// loaded, so the pad rows (which may hold anything, NaN included) cannot
// reach y. Output: the interior and zero pad cols; pad rows are not written.
//
// What bounds it on the H100: bytes at the 128^2 -> 64^2 call (N = 56, C = D
// = 128: 235 MB of interior in, 59 MB out, 67.6 GFLOP) and operations at
// 64^2 -> 32^2. Design: K4a's implicit GEMM (M = N * H/2 * W/2 output pixels,
// K = 9 C tap-major, N = D) with a stride-2 gather; a block owns 64 output
// pixels x 64 output channels, each thread gathers the same two rows for the
// whole K loop, and the epilogue writes the zero pad cols of its rows.
#include "common.cuh"

namespace v2a {
namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
downconv3x3_padded_kernel(const T* __restrict__ x, const float* __restrict__ a,
                          const float* __restrict__ b, const T* __restrict__ w,
                          const float* __restrict__ bias, T* __restrict__ y, int N, int H, int W,
                          int Wp, int Wp2, int C, int D, int mode) {
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int H2 = H / 2, W2 = W / 2;
  const long M = (long)N * H2 * W2;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int Hp = H + 2, Hp2 = H2 + 2;

  constexpr int SLOTS = (BM * BK) / (THREADS * 8);
  int rrow[SLOTS], rcg[SLOTS], rn[SLOTS], ri[SLOTS], rj[SLOTS];
  bool rvalid[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    int idx = tid + s * THREADS;
    rrow[s] = idx / (BK / 8);
    rcg[s] = (idx % (BK / 8)) * 8;
    long m = m0 + rrow[s];
    rvalid[s] = m < M;
    long mm = rvalid[s] ? m : 0;
    rn[s] = (int)(mm / ((long)H2 * W2));
    int rem = (int)(mm % ((long)H2 * W2));
    ri[s] = rem / W2;  // output interior coordinates
    rj[s] = rem % W2;
  }

  Accum<T> acc;
  acc.zero();
  for (int tap = 0; tap < 9; ++tap) {
    const int di = tap / 3, dj = tap % 3;
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int pr = 2 * ri[s] + di, pc = 2 * rj[s] + dj;  // padded input coordinates
        T* dst = &As[rrow[s]][rcg[s]];
        if (!rvalid[s] || pr < 1 || pr > H || pc < 1 || pc > W) {
          zero8(dst);  // outside the interior: zero after the activation
          continue;
        }
        const long off = (((long)rn[s] * Hp + pr) * Wp + pc) * C + c0 + rcg[s];
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
    if (m >= M) continue;
    const long n = m / ((long)H2 * W2);
    const int rem = (int)(m % ((long)H2 * W2));
    const int i = rem / W2, j = rem % W2;
    const long o = ((n * Hp2 + i + 1) * Wp2 + j + 1) * D + n0 + c;
    y[o] = from_f<T>(Cs[r][c] + bias[n0 + c]);
    zero_pad_cols(y, o, j, W2, Wp2, D);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b, const void* w, const void* bias,
                   void* y, int N, int H, int W, int Wp, int Wp2, int C, int D, int mode,
                   cudaStream_t stream) {
  const long M = (long)N * (H / 2) * (W / 2);
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(D / BN));
  downconv3x3_padded_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const T*>(w), static_cast<const float*>(bias), static_cast<T*>(y), N, H, W, Wp,
      Wp2, C, D, mode);
  return cudaGetLastError();
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. mode: 0 no activation, 1 affine, 2
// affine+SiLU (a, b (N, C) float32; null in mode 0). x (N, H+2, Wp, C),
// w (9 C, D), y (N, H/2+2, Wp2, D). Needs even H and W, C % 32 == 0,
// D % 64 == 0, 16-byte aligned contiguous buffers.
extern "C" int v2a_downconv3x3_padded(const void* x, const void* a, const void* b, const void* w,
                                      const void* bias, void* y, int N, int H, int W, int Wp,
                                      int Wp2, int C, int D, int mode, int dtype, void* stream) {
  if (C % v2a::BK || D % v2a::BN || H % 2 || W % 2 || Wp < W + 2 || Wp2 < W / 2 + 2 ||
      (mode != 0 && (a == nullptr || b == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::launch<__nv_bfloat16>(x, a, b, w, bias, y, N, H, W, Wp, Wp2, C, D, mode, s);
  if (dtype == 0)
    return (int)v2a::launch<float>(x, a, b, w, bias, y, N, H, W, Wp, Wp2, C, D, mode, s);
  return (int)cudaErrorInvalidValue;
}
