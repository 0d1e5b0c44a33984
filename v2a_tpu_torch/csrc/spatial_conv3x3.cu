// K10: y = conv3x3_same(x) + bias on (N, H, W, C) -> (N, H, W, D): the plain
// 3x3 conv of the routing without the K1 gate, its input already normed by
// the caller.
//
// Replaces the TPU kernel `spatial_conv3x3`
// (v2a_tpu/ops/resblock_kernels.py:2796, body `_spatial3x3_kernel` :2760).
//
// The nine tap products are summed in float32 and the bias is added once,
// then rounded to the input type once, as the TPU kernel does. The SAME halo
// is zero: taps that fall outside the frame are skipped (their shared-memory
// cells are zero-filled), and no padded copy of x is ever made.
//
// What bounds it on the H100: operations (at 64^2 x 256 -> 256, N = 56,
// 2.7e11 FLOP against ~0.2 GB of traffic). Design: the TPU kernel copies a
// halo'd band of rows into VMEM once and reads the nine shifted taps out of
// it. Here a block owns 64 consecutive output pixels of one image (a row
// segment at W >= 64, whole rows below) x 64 output channels. Per 32-channel
// step it loads the band those pixels need, their rows and cols plus the
// one-pixel halo, into shared memory ONCE (each input element is read from
// device memory once per block instead of nine times), then builds the nine
// shifted 64 x 32 A tiles from that band and multiplies each with its weight
// slab on the tensor cores (wmma bf16, float32 accumulators).
#include "common.cuh"

namespace v2a {
namespace {

// the band of a tile: image rows rlo..rhi and cols clo..chi hold its pixels
struct Band {
  int rlo, rhi, clo, chi;
  __host__ __device__ int rows() const { return rhi - rlo + 3; }  // with the halo
  __host__ __device__ int cols() const { return chi - clo + 3; }
};

__host__ __device__ inline Band band_of(int tile, int H, int W) {
  const int p0 = tile * BM;
  const int p1 = (p0 + BM < H * W ? p0 + BM : H * W) - 1;
  Band bd{p0 / W, p1 / W, 0, W - 1};
  if (bd.rlo == bd.rhi) {
    bd.clo = p0 % W;
    bd.chi = p1 % W;
  }
  return bd;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
spatial_conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ y, int H, int W, int C,
                       int D, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];
  constexpr int LDS = Lds<T>::A;  // one band cell: BK channels + the row pad
  T* slab = reinterpret_cast<T*>(smem);

  const int n = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int HW = H * W;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const Band bd = band_of(tile, H, W);
  const int SR = bd.rows(), SC = bd.cols();
  const T* xn = x + (long)n * HW * C;

  constexpr int SLOTS = (BM * BK) / (THREADS * 8);
  int rrow[SLOTS], rcg[SLOTS], rcell[SLOTS];
  bool rv[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int idx = tid + s * THREADS;
    rrow[s] = idx / (BK / 8);
    rcg[s] = (idx % (BK / 8)) * 8;
    const int p = tile * BM + rrow[s];
    rv[s] = p < HW;
    // the band cell of tap (0, 0): one row and one col up-left of the pixel
    rcell[s] = rv[s] ? (p / W - bd.rlo) * SC + (p % W - bd.clo) : 0;
  }

  Accum<T> acc;
  acc.zero();
  for (int c0 = 0; c0 < C; c0 += BK) {
    // the band with its halo, read once; out-of-frame cells are zero
    for (int idx = tid; idx < SR * SC * (BK / 8); idx += THREADS) {
      const int cell = idx / (BK / 8), cg = (idx % (BK / 8)) * 8;
      const int hh = bd.rlo - 1 + cell / SC, ww = bd.clo - 1 + cell % SC;
      T* dst = slab + (long)cell * LDS + cg;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W)
        copy8(dst, xn + ((long)hh * W + ww) * C + c0 + cg);
      else
        zero8(dst);
    }
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * SC + tap % 3;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        if (rv[s])
          copy8(&As[rrow[s]][rcg[s]], slab + (long)(rcell[s] + shift) * LDS + rcg[s]);
        else
          zero8(&As[rrow[s]][rcg[s]]);
      }
      load_b_tile<T>(Bs, w, (long)tap * C + c0, D, n0);
      __syncthreads();
      acc.step(As, Bs);
      __syncthreads();  // also: every read of the band is done before the next load
    }
  }
  acc.store(Cs);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int p = tile * BM + r;
    if (p < HW) y[((long)n * HW + p) * D + n0 + c] = from_f<T>(Cs[r][c] + bias[n0 + c]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y, int N, int H, int W,
                   int C, int D, cudaStream_t stream) {
  const int tiles = (H * W + BM - 1) / BM;
  int cells = 0;
  for (int t = 0; t < tiles; ++t) {
    const Band bd = band_of(t, H, W);
    cells = bd.rows() * bd.cols() > cells ? bd.rows() * bd.cols() : cells;
  }
  const size_t dyn = (size_t)cells * Lds<T>::A * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(spatial_conv3x3_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(N * tiles), (unsigned)(D / BN));
  spatial_conv3x3_kernel<T><<<grid, THREADS, dyn, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), H, W, C, D, tiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. x (N, H, W, C), w (9 C, D) tap-major
// (di*3+dj), bias (D) float32, y (N, H, W, D). Needs C % 32 == 0,
// D % 64 == 0, 16-byte aligned contiguous buffers.
extern "C" int v2a_spatial_conv3x3(const void* x, const void* w, const void* bias, void* y, int N,
                                   int H, int W, int C, int D, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % v2a::BK || D <= 0 || D % v2a::BN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)v2a::launch<__nv_bfloat16>(x, w, bias, y, N, H, W, C, D, s);
  if (dtype == 0) return (int)v2a::launch<float>(x, w, bias, y, N, H, W, C, D, s);
  return (int)cudaErrorInvalidValue;
}
