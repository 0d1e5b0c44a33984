// K4a: y = sum_i conv3x3_same(mask(act_i(x_i))) + bias over a padded stream,
// x_i (N, H+2, Wp, C_i) -> y (N, H+2, Wp, D), one or two channel parts.
//
// Replaces the TPU kernel `fused_affine_conv3x3_padded`
// (v2a_tpu/ops/resblock_kernels.py:902, body `_padded_conv_kernel` :815).
//
// act_i(x) = silu(a_i[n, c] * x + b_i[n, c]) (silu = 1) or the affine alone
// (silu = 0), in float32, rounded to the input type, as K1 computes it. The
// interior is rows 1..H, cols 1..W of the padded layout; a tap that falls
// outside it contributes zero AFTER the activation, and its value is never
// loaded, so whatever the pad rows hold (NaN included) cannot reach y. All
// parts feed ONE float32 accumulator and the bias is added once.
// Output: the interior and zero pad cols; pad rows are not written.
//
// What bounds it on the H100: operations (at 32^2 x 384 -> 384, N = 56,
// 1.4e11 FLOP against ~0.1 GB). Design: K1's implicit GEMM (M = N*H*W
// interior pixels, K = sum_i 9*C_i tap-major, N = D) with the padded row
// stride; a block owns 64 pixels x 64 channels, loops over the parts' K
// segments into the same wmma accumulators, and its epilogue also writes
// the zero pad cols next to the first and last interior col.
#include "common.cuh"

namespace v2a {
namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
affine_conv3x3_padded_kernel(Part<T> p0, Part<T> p1, const float* __restrict__ bias,
                             T* __restrict__ y, int N, int H, int W, int Wp, int D, int silu) {
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const long M = (long)N * H * W;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
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
    rh[s] = rem / W;  // interior coordinates
    rw[s] = rem % W;
  }

  Accum<T> acc;
  acc.zero();
  for (int part = 0; part < 2; ++part) {
    const Part<T> P = part ? p1 : p0;
    for (int tap = 0; tap < 9 && P.C; ++tap) {
      // output padded (h+1, w+1) reads padded (h+di, w+dj), di, dj in 0..2
      const int di = tap / 3, dj = tap % 3;
      for (int c0 = 0; c0 < P.C; c0 += BK) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int pr = rh[s] + di, pc = rw[s] + dj;
          T* dst = &As[rrow[s]][rcg[s]];
          if (!rvalid[s] || pr < 1 || pr > H || pc < 1 || pc > W) {
            zero8(dst);  // outside the interior: zero after the activation
            continue;
          }
          float v[8];
          load8(P.x + (((long)rn[s] * Hp + pr) * Wp + pc) * P.C + c0 + rcg[s], v);
          const long aoff = (long)rn[s] * P.C + c0 + rcg[s];
          affine8(v, P.a + aoff, P.b + aoff, silu);
          store8(dst, v);  // rounded to T before the product
        }
        load_b_tile<T>(Bs, P.w, (long)tap * P.C + c0, D, n0);
        __syncthreads();
        acc.step(As, Bs);
        __syncthreads();
      }
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
    const int h = rem / W, w = rem % W;
    const long o = ((n * Hp + h + 1) * Wp + w + 1) * D + n0 + c;
    y[o] = from_f<T>(Cs[r][c] + bias[n0 + c]);
    zero_pad_cols(y, o, w, W, Wp, D);
  }
}

template <typename T>
cudaError_t launch(const void* const* pa, const int* C, const void* bias, void* y, int N, int H,
                   int W, int Wp, int D, int silu, cudaStream_t stream) {
  Part<T> p[2];
  parts_from(pa, C, p);
  const long M = (long)N * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(D / BN));
  affine_conv3x3_padded_kernel<T><<<grid, THREADS, 0, stream>>>(
      p[0], p[1], static_cast<const float*>(bias), static_cast<T*>(y), N, H, W, Wp, D, silu);
  return cudaGetLastError();
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. Part i: x_i (N, H+2, Wp, C_i), a_i / b_i
// (N, C_i) float32, w_i (9 C_i, D); C1 = 0 (and null pointers) for one part.
// Needs C_i % 32 == 0, D % 64 == 0, Wp % 8 == 0, 16-byte aligned buffers.
extern "C" int v2a_affine_conv3x3_padded(const void* x0, const void* a0, const void* b0,
                                         const void* w0, const void* x1, const void* a1,
                                         const void* b1, const void* w1, const void* bias,
                                         void* y, int N, int H, int W, int Wp, int C0, int C1,
                                         int D, int silu, int dtype, void* stream) {
  if (C0 <= 0 || C0 % v2a::BK || C1 % v2a::BK || D % v2a::BN || Wp % 8 || Wp < W + 2)
    return (int)cudaErrorInvalidValue;
  const void* pa[8] = {x0, a0, b0, w0, x1, a1, b1, w1};
  const int C[2] = {C0, C1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::launch<__nv_bfloat16>(pa, C, bias, y, N, H, W, Wp, D, silu, s);
  if (dtype == 0) return (int)v2a::launch<float>(pa, C, bias, y, N, H, W, Wp, D, silu, s);
  return (int)cudaErrorInvalidValue;
}
