// K7: GroupNorm(G) with float32 statistics, affine and optional SiLU,
// x (B, S, C) channels-last -> y (B, S, C) in x's type.
//
// Replaces the TPU kernel `fused_group_norm_silu`
// (v2a_tpu/ops/pallas_kernels.py:111, bodies `_stats_kernel` :40 and
// `_apply_kernel` :72).
//
// Per (batch, group): sum and sum of squares over (S, C / G) in float32;
// mean = sum / n, var = sumsq / n - mean^2 (not clamped at zero, as the TPU
// kernel), rstd = rsqrt(var + eps); y = (x - mean) * rstd * scale + bias,
// then y * (1 / (1 + exp(-y))) with silu, each step rounded as the plain
// version rounds it (no fused multiply-add), rounded to T once.
//
// What bounds it on the H100: bytes (a statistics read, then a read and a
// write: 235 MB per pass at (8, 114688, 128) bf16). Design, three launches:
//   1. statistics partials: block (split, batch) sums a range of rows with
//      8-channel vector loads, each thread over its own rows in order, then
//      folds its threads and the channels of each group in a fixed order in
//      shared memory and writes one (sum, sumsq) per group;
//   2. one block per batch adds the splits in order and writes (mean, rstd)
//      per group (deterministic: no float atomics anywhere);
//   3. the apply pass, one read and one write per element.
#include "common.cuh"

namespace v2a {
namespace {

// blockDim.x = (C / 8) * rpp: thread t owns channels (t % (C/8)) * 8 .. +8 and
// rows r0 + t / (C/8), stepping by rpp.
template <typename T>
__global__ void gn_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, int S,
                                  int C, int G, int splits, int rpp) {
  extern __shared__ float red[];  // [2][rpp][C]
  const int split = blockIdx.x, b = blockIdx.y;
  const int groups8 = C / 8;
  const int cg = threadIdx.x % groups8, rr = threadIdx.x / groups8;
  const int rows = (S + splits - 1) / splits;
  const int r0 = split * rows, r1 = min(S, r0 + rows);
  float s[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = q[k] = 0.f;
  for (int r = r0 + rr; r < r1; r += rpp) {
    float v[8];
    load8(x + ((long)b * S + r) * C + cg * 8, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s[k] = __fadd_rn(s[k], v[k]);
      q[k] = __fadd_rn(q[k], __fmul_rn(v[k], v[k]));
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    red[(long)rr * C + cg * 8 + k] = s[k];
    red[(long)(rpp + rr) * C + cg * 8 + k] = q[k];
  }
  __syncthreads();
  const int gw = C / G;
  for (int t = threadIdx.x; t < 2 * G; t += blockDim.x) {
    const int g = t >> 1, which = t & 1;
    float acc = 0.f;
    for (int c = g * gw; c < (g + 1) * gw; ++c)
      for (int i = 0; i < rpp; ++i) acc = __fadd_rn(acc, red[(long)(which * rpp + i) * C + c]);
    partial[(((long)b * splits + split) * G + g) * 2 + which] = acc;
  }
}

__global__ void gn_finalize_kernel(const float* __restrict__ partial, float* __restrict__ mean_rstd,
                                   int S, int C, int G, int splits, float eps) {
  const int b = blockIdx.x;
  const float n = (float)((double)S * (C / G));
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float sum = 0.f, sumsq = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float* p = partial + (((long)b * splits + i) * G + g) * 2;
      sum = __fadd_rn(sum, p[0]);
      sumsq = __fadd_rn(sumsq, p[1]);
    }
    const float mean = __fdiv_rn(sum, n);
    const float var = __fsub_rn(__fdiv_rn(sumsq, n), __fmul_rn(mean, mean));
    mean_rstd[((long)b * G + g) * 2] = mean;
    mean_rstd[((long)b * G + g) * 2 + 1] = rsqrtf(__fadd_rn(var, eps));
  }
}

template <typename T>
__global__ void gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean_rstd,
                                const float* __restrict__ scale, const float* __restrict__ bias,
                                T* __restrict__ y, int S, int C, int G, long n_vec, int silu) {
  const int groups8 = C / 8, gw = C / G;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += (long)gridDim.x * blockDim.x) {
    const long row = i / groups8;  // b * S + r
    const int c0 = (int)(i % groups8) * 8;
    const long b = row / S;
    float v[8];
    load8(x + row * C + c0, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + k;
      const float* mr = mean_rstd + (b * G + c / gw) * 2;
      float t = __fmul_rn(__fsub_rn(v[k], mr[0]), mr[1]);
      t = __fadd_rn(__fmul_rn(t, scale[c]), bias[c]);
      if (silu) t = __fmul_rn(t, 1.f / (1.f + expf(-t)));
      v[k] = t;
    }
    store8(y + row * C + c0, v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* partial,
                   void* mean_rstd, void* y, int B, int S, int C, int G, int splits, int silu,
                   float eps, cudaStream_t stream) {
  const int groups8 = C / 8;
  const int rpp = groups8 >= 256 ? 1 : 256 / groups8;
  const size_t smem = (size_t)2 * rpp * C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gn_partial_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  gn_partial_kernel<T><<<dim3(splits, B), groups8 * rpp, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partial), S, C, G, splits, rpp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gn_finalize_kernel<<<B, 32 * ((G + 31) / 32), 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(mean_rstd), S, C, G, splits, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long n_vec = (long)B * S * groups8;
  const long blocks = (n_vec + 255) / 256;
  gn_apply_kernel<T><<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean_rstd),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<T*>(y), S, C,
      G, n_vec, silu);
  return cudaGetLastError();
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. x, y (B, S, C); scale, bias (C,) float32;
// partial (B * splits * G * 2) and mean_rstd (B * G * 2) float32 scratch.
// Needs C % G == 0, C % 8 == 0, C <= 8192, G <= 1024, 16-byte aligned buffers.
extern "C" int v2a_group_norm_silu(const void* x, const void* scale, const void* bias,
                                   void* partial, void* mean_rstd, void* y, int B, int S, int C,
                                   int G, int splits, int silu, int dtype, float eps,
                                   void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || G > 1024 || C % G || C % 8 || C > 8192 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::launch<__nv_bfloat16>(x, scale, bias, partial, mean_rstd, y, B, S, C, G,
                                           splits, silu, eps, s);
  if (dtype == 0)
    return (int)v2a::launch<float>(x, scale, bias, partial, mean_rstd, y, B, S, C, G, splits,
                                   silu, eps, s);
  return (int)cudaErrorInvalidValue;
}
