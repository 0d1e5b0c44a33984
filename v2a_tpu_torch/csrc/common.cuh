// Shared pieces of the hand-written Hopper kernels: the block tile, 8-wide
// vector loads/stores, and the per-block product of an A tile (BM x BK)
// with a B tile (BK x BN) accumulated in float32.
//
// bf16 runs on the tensor cores through nvcuda::wmma 16x16x16 fragments;
// float32 runs on the CUDA cores (a 8x4 register micro-tile per thread).
// Both take the same shared-memory tiles, so the kernels that include this
// header only write their own A-tile gather and epilogue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace v2a {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // reduction depth per shared-memory stage
constexpr int THREADS = 128;  // four warps, 2 x 2 over the 64 x 64 tile

template <typename T> struct Lds;
template <> struct Lds<__nv_bfloat16> {
  static constexpr int A = BK + 8;  // row pads keep wmma rows off one bank
  static constexpr int B = BN + 8;
};
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

// bf16: each warp owns a 32 x 32 quarter of the tile as 2 x 2 wmma fragments.
template <> struct Accum<__nv_bfloat16> {
  using T = __nv_bfloat16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[2][2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(c[i][j], 0.f);
  }
  __device__ __forceinline__ void step(T (*As)[Lds<T>::A], T (*Bs)[Lds<T>::B]) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], Lds<T>::A);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16], Lds<T>::B);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }
  __device__ __forceinline__ void store(float (*Cs)[C_LD]) {
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], c[i][j], C_LD,
                                        nvcuda::wmma::mem_row_major);
  }
};

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

}  // namespace v2a
