// Shared pieces of the hand-written Hopper kernels: 8-wide vector
// loads/stores, the activation's rounding, and the float32 bodies' block
// tile: the product of an A tile (BM x BK) with a B tile (BK x BN) on the
// CUDA cores (a 8x4 register micro-tile per thread), so the kernels that
// include this header only write their own A-tile gather and epilogue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace v2a {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // reduction depth per shared-memory stage
constexpr int THREADS = 128;  // four warps, 2 x 2 over the 64 x 64 tile

template <typename T> struct Lds;
template <> struct Lds<float> {
  static constexpr int A = BK + 4;
  static constexpr int B = BN + 4;
};
constexpr int C_LD = BN + 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive elements <-> 8 floats. Callers keep p 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}
// raw copy of 8 elements (no conversion)
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src) {
#pragma unroll
  for (int i = 0; i < (int)(8 * sizeof(T) / 16); ++i)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}
template <typename T>
__device__ __forceinline__ void zero8(T* dst) {
#pragma unroll
  for (int i = 0; i < (int)(8 * sizeof(T) / 16); ++i)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(0, 0, 0, 0);
}

// One channel part of a padded-stream conv input: x (..., C) with its
// per-row float32 affine a, b (rows, C) and its (9 C, D) weights. C = 0
// marks an absent part.
template <typename T>
struct Part {
  const T* x;
  const float* a;
  const float* b;
  const T* w;
  int C;
};

// One part of a folded 1x1 skip projection: x (..., C) and k (C, D). C = 0
// marks an absent part.
template <typename T>
struct Skip {
  const T* x;
  const T* k;
  int C;
};

// Two parts from the C interface's pointer list {x0, a0, b0, w0, x1, ...}.
template <typename T>
inline void parts_from(const void* const* pa, const int* C, Part<T> p[2]) {
  for (int i = 0; i < 2; ++i)
    p[i] = Part<T>{static_cast<const T*>(pa[4 * i]), static_cast<const float*>(pa[4 * i + 1]),
                   static_cast<const float*>(pa[4 * i + 2]), static_cast<const T*>(pa[4 * i + 3]),
                   C[i]};
}

// Two skip parts from the C interface's pointer list {x0, k0, x1, k1}.
template <typename T>
inline void skips_from(const void* const* sk, const int* C, Skip<T> q[2]) {
  for (int i = 0; i < 2; ++i)
    q[i] = Skip<T>{static_cast<const T*>(sk[2 * i]), static_cast<const T*>(sk[2 * i + 1]), C[i]};
}

// v[i] = silu(a[i] * v[i] + b[i]) (or the affine alone) on 8 channels, in
// float32 and rounded as the plain versions round it: no fused multiply-add,
// silu as t * (1 / (1 + exp(-t))), the reciprocal correctly rounded
// (__frcp_rn: the value of 1.f / x without the division routine). a, b:
// 16-byte aligned float32.
__device__ __forceinline__ void affine8(float v[8], const float* a, const float* b, bool silu) {
  float av[8], bv[8];
  load8(a, av);
  load8(b, bv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float t = __fadd_rn(__fmul_rn(v[i], av[i]), bv[i]);
    if (silu) t = __fmul_rn(t, __frcp_rn(1.f + expf(-t)));
    v[i] = t;
  }
}

// Loads the BK x BN slab of a row-major (K, ldb) weight matrix starting at
// row k0, column n0 into Bs. Needs ldb % 8 == 0.
template <typename T>
__device__ __forceinline__ void load_b_tile(T (*Bs)[Lds<T>::B], const T* __restrict__ w,
                                            long k0, int ldb, int n0) {
#pragma unroll
  for (int s = 0; s < (BK * BN) / (THREADS * 8); ++s) {
    int idx = threadIdx.x + s * THREADS;
    int k = idx / (BN / 8);
    int jg = (idx % (BN / 8)) * 8;
    copy8(&Bs[k][jg], w + (k0 + k) * ldb + n0 + jg);
  }
}

template <typename T> struct Accum;

// float32: thread (ty, tx) owns rows ty*8..+8 and columns tx*4..+4.
template <> struct Accum<float> {
  using T = float;
  float c[8][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }
  __device__ __forceinline__ void step(T (*As)[Lds<T>::A], T (*Bs)[Lds<T>::B]) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float a = As[ty * 8 + i][k];
        c[i][0] += a * b.x;
        c[i][1] += a * b.y;
        c[i][2] += a * b.z;
        c[i][3] += a * b.w;
      }
    }
  }
  __device__ __forceinline__ void store(float (*Cs)[C_LD]) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[ty * 8 + i][tx * 4 + j] = c[i][j];
  }
};

// The statistics of the temporal-conv kernels: each block writes the column
// sums of its tile, partial[(slab * tiles + tile) * 2 + which][C], and this
// second pass adds the tiles in tile order (deterministic, no atomics):
// stats[slab][which][c] = sum over tiles.
namespace {
__global__ void reduce_tiles_kernel(const float* __restrict__ partial, float* __restrict__ stats,
                                    long n_out, int C, int tiles) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const long slab = i / (2 * C);
  const long wc = i % (2 * C);
  float sum = 0.f;
  for (int t = 0; t < tiles; ++t) sum += partial[(slab * tiles + t) * 2 * C + wc];
  stats[i] = sum;
}
}  // namespace

inline cudaError_t reduce_tiles(const float* partial, float* stats, long slabs, int C, int tiles,
                                cudaStream_t stream) {
  const long n_out = slabs * 2 * C;
  reduce_tiles_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, stream>>>(partial, stats, n_out,
                                                                           C, tiles);
  return cudaGetLastError();
}

// Zeroes the pad cols of one interior row of a padded stream, given the
// offset o of the element at interior col w (padded col w + 1) of channel
// c: col 0 when w == 0, cols W+1 .. Wp-1 when w == W-1. ld: channels.
template <typename T>
__device__ __forceinline__ void zero_pad_cols(T* y, long o, int w, int W, int Wp, int ld) {
  if (w == 0) y[o - ld] = from_f<T>(0.f);
  if (w == W - 1)
    for (int k = 1; k < Wp - W; ++k) y[o + (long)k * ld] = from_f<T>(0.f);
}

}  // namespace v2a
