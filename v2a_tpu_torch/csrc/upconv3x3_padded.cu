// K5: y = conv3x3_same(nearest_2x(act(x))) + bias from a low-res padded
// stream x (N, H+2, Wp, C) into the high-res padded stream
// y (N, 2H+2, Wph, D).
//
// Replaces the TPU kernel `fused_upconv3x3_padded`
// (v2a_tpu/ops/resblock_kernels.py:1314, body `_upconv_kernel` :1222).
//
// The 3x3 conv of the 2x nearest-upsampled input collapses to four parity
// convs over the LOW-RES input: output (2u + p, 2v + p') is a 2x2 conv at
// low-res padded rows u + p + {0, 1} and cols v + p' + {0, 1} with the
// collapsed weights w16[p][p'][a][b] (the wrapper sums the 3x3 taps in
// float32 and rounds the sums to the input type, as the TPU kernel's host
// code does). Taps outside the low-res interior are zero after the optional
// activation and are never loaded (this reproduces the high-res zero halo).
// act(x) = silu(a[n, c] * x + b[n, c]) (mode 2), the affine (mode 1) or x
// (mode 0). y gets its interior and zero pad cols, not its pad rows.
//
// What bounds it on the H100: operations (at 64^2 -> 128^2 x 256, N = 56,
// 4.8e11 FLOP, 16/36 of the upsampled conv's, against ~0.3 GB). Design:
// one implicit GEMM per output parity (grid z): M = N*H*W low-res pixels,
// K = 4*C, N = D, tiles as K1; the upsampled input never exists.
#include "common.cuh"

namespace v2a {
namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
upconv3x3_padded_kernel(const T* __restrict__ x, const float* __restrict__ a,
                        const float* __restrict__ b, const T* __restrict__ w16,
                        const float* __restrict__ bias, T* __restrict__ y, int N, int H, int W,
                        int Wp, int Wph, int C, int D, int mode) {
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const long M = (long)N * H * W;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int parity = blockIdx.z, p = parity >> 1, pp = parity & 1;
  const int tid = threadIdx.x;
  const int Hp = H + 2;

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
    rh[s] = rem / W;  // low-res interior coordinates
    rw[s] = rem % W;
  }

  Accum<T> acc;
  acc.zero();
  for (int tap = 0; tap < 4; ++tap) {
    const int pr_off = (tap >> 1) + p, pc_off = (tap & 1) + pp;
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int pr = rh[s] + pr_off, pc = rw[s] + pc_off;  // low-res padded coordinates
        T* dst = &As[rrow[s]][rcg[s]];
        if (!rvalid[s] || pr < 1 || pr > H || pc < 1 || pc > W) {
          zero8(dst);
          continue;
        }
        const T* src = x + (((long)rn[s] * Hp + pr) * Wp + pc) * C + c0 + rcg[s];
        if (mode == 0) {
          copy8(dst, src);
          continue;
        }
        float v[8];
        load8(src, v);
        const long aoff = (long)rn[s] * C + c0 + rcg[s];
        affine8(v, a + aoff, b + aoff, mode == 2);
        store8(dst, v);
      }
      load_b_tile<T>(Bs, w16, (long)(parity * 4 + tap) * C + c0, D, n0);
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
    const long n = m / ((long)H * W);
    const int rem = (int)(m % ((long)H * W));
    const int hh = 2 * (rem / W) + p, wh = 2 * (rem % W) + pp;  // high-res interior
    const long o = ((n * (2 * H + 2) + hh + 1) * Wph + wh + 1) * D + n0 + c;
    y[o] = from_f<T>(Cs[r][c] + bias[n0 + c]);
    zero_pad_cols(y, o, wh, 2 * W, Wph, D);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b, const void* w16,
                   const void* bias, void* y, int N, int H, int W, int Wp, int Wph, int C, int D,
                   int mode, cudaStream_t stream) {
  const long M = (long)N * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(D / BN), 4);
  upconv3x3_padded_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const T*>(w16), static_cast<const float*>(bias), static_cast<T*>(y), N, H, W,
      Wp, Wph, C, D, mode);
  return cudaGetLastError();
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. x (N, H+2, Wp, C); a, b (N, C) float32
// or null (mode 0); w16 (16 C, D), row block (p * 2 + p') * 4 + a * 2 + b;
// bias (D) float32; y (N, 2H+2, Wph, D). mode: 0 none, 1 affine, 2 affine +
// SiLU. Needs C % 32 == 0, D % 64 == 0, Wp and Wph % 8 == 0, 16-byte
// aligned buffers.
extern "C" int v2a_upconv3x3_padded(const void* x, const void* a, const void* b, const void* w16,
                                    const void* bias, void* y, int N, int H, int W, int Wp,
                                    int Wph, int C, int D, int mode, int dtype, void* stream) {
  if (C % v2a::BK || D % v2a::BN || Wp % 8 || Wph % 8 || Wp < W + 2 || Wph < 2 * W + 2 ||
      (mode && (!a || !b)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::launch<__nv_bfloat16>(x, a, b, w16, bias, y, N, H, W, Wp, Wph, C, D, mode,
                                           s);
  if (dtype == 0)
    return (int)v2a::launch<float>(x, a, b, w16, bias, y, N, H, W, Wp, Wph, C, D, mode, s);
  return (int)cudaErrorInvalidValue;
}
