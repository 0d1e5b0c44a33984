// K6: dW[di, dj, ci, co] = sum_{n,h,w} s[n, h+di-1, w+dj-1, ci] * g[n, h, w, co],
// the weight gradient of y = conv3x3_same(s) with s = act(x), (3, 3, C, D)
// float32.
//
// Replaces the TPU kernel `wgrad_conv3x3`
// (v2a_tpu/ops/resblock_kernels.py:3329, body `_wgrad3x3_kernel` :3237).
//
// act(x) = silu(a[n, c] * x + b[n, c]) (mode 2), a[n, c] * x + b[n, c]
// (mode 1) or x (mode 0), recomputed from the raw input in the gather,
// rounded to the input type before the product and zero for every tap that
// falls outside the frame (after the activation, as the TPU kernel re-zeroes
// its padded band). The rounding is K1's: `affine8` in common.cuh.
//
// What bounds it on the H100: operations. It is a GEMM with M = 9 C,
// N = D and a very long K = N*H*W pixels (2.1e11 FLOP at 28 x 128^2 x
// 128 -> 128 against ~0.06 GB of traffic); the output is tiny (36 tiles of
// 64 x 64 at C = D = 128), so the parallelism has to come from K.
// Design: the TPU kernel carries one float32 accumulator across a
// sequential (n, band) grid; blocks on the card run in no order. So a
// block owns an (M tile = one tap x 64 input channels, N tile = 64 output
// channels, pixel chunk) triple, gathers 32 shifted, activated pixels x 64
// channels and the matching 32 x 64 slab of g per step into shared memory,
// and multiplies them on the tensor cores (wmma bf16, A read column-major,
// float32 accumulators). It writes its float32 partial sums to a scratch
// buffer, one dW-shaped slab per chunk, and a second pass adds the chunks
// in chunk order: no float atomics, two runs bit-equal. The wrapper picks
// the chunk count so that about eight blocks per SM are in flight.
#include "common.cuh"

namespace v2a {
namespace {

constexpr int WK = 32;  // pixels per shared-memory stage (the GEMM's K step)

template <typename T> struct WLds;
template <> struct WLds<__nv_bfloat16> {
  static constexpr int S = BM + 8;  // row pads keep wmma rows off one bank
  static constexpr int G = BN + 8;
};
template <> struct WLds<float> {
  static constexpr int S = BM + 4;
  static constexpr int G = BN + 4;
};

template <typename T> struct WAccum;

// bf16: each warp owns a 32 x 32 quarter of the 64 x 64 (ci, co) tile. A is
// the gathered (pixel, ci) tile read column-major, i.e. s^T.
template <> struct WAccum<__nv_bfloat16> {
  using T = __nv_bfloat16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[2][2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(c[i][j], 0.f);
  }
  __device__ __forceinline__ void step(T (*Ss)[WLds<T>::S], T (*Gs)[WLds<T>::G]) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &Ss[kk][wm * 32 + i * 16], WLds<T>::S);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Gs[kk][wn * 32 + j * 16], WLds<T>::G);
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

// float32: thread (ty, tx) owns channels ty*8..+8 and outputs tx*4..+4.
template <> struct WAccum<float> {
  using T = float;
  float c[8][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }
  __device__ __forceinline__ void step(T (*Ss)[WLds<T>::S], T (*Gs)[WLds<T>::G]) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < WK; ++k) {
      float4 b = *reinterpret_cast<const float4*>(&Gs[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float a = Ss[k][ty * 8 + i];
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ b, const T* __restrict__ g,
                     float* __restrict__ dst, int N, int H, int W, int C, int D,
                     int chunk_len, int mode) {
  __shared__ __align__(128) T Ss[WK][WLds<T>::S];
  __shared__ __align__(128) T Gs[WK][WLds<T>::G];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int cblocks = C / BM;
  const int tap = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x % cblocks) * BM;
  const int n0 = blockIdx.y * BN;
  const int di = tap / 3 - 1, dj = tap % 3 - 1;
  const long HW = (long)H * W;
  const long P = (long)N * HW;
  const long p_begin = (long)blockIdx.z * chunk_len;
  const long p_end = p_begin + chunk_len < P ? p_begin + chunk_len : P;
  const int tid = threadIdx.x;

  // each thread fills the same (pixel row, 8-channel group) slots of both
  // tiles at every step
  constexpr int SLOTS = (WK * BM) / (THREADS * 8);
  static_assert(SLOTS * THREADS * 8 == WK * BN, "the two tiles share the slot map");

  WAccum<T> acc;
  acc.zero();
  for (long p0 = p_begin; p0 < p_end; p0 += WK) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int idx = tid + s * THREADS;
      const int pk = idx / (BM / 8), cg = (idx % (BM / 8)) * 8;
      const long p = p0 + pk;
      T* sdst = &Ss[pk][cg];
      T* gdst = &Gs[pk][cg];
      if (p >= p_end) {
        zero8(sdst);
        zero8(gdst);
        continue;
      }
      copy8(gdst, g + p * D + n0 + cg);
      const int n = (int)(p / HW);
      const int rem = (int)(p % HW);
      const int hh = rem / W + di, ww = rem % W + dj;
      if (hh < 0 || hh >= H || ww < 0 || ww >= W) {
        zero8(sdst);  // the halo is zero after the activation
        continue;
      }
      const long off = (((long)n * H + hh) * W + ww) * C + c0 + cg;
      if (mode == 0) {
        copy8(sdst, x + off);
        continue;
      }
      float v[8];
      load8(x + off, v);
      const long aoff = (long)n * C + c0 + cg;
      affine8(v, a + aoff, b + aoff, mode == 2);
      store8(sdst, v);  // rounded to T before the product
    }
    __syncthreads();
    acc.step(Ss, Gs);
    __syncthreads();
  }
  acc.store(Cs);
  __syncthreads();
  float* out = dst + (long)blockIdx.z * 9 * C * D;
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, col = idx % BN;
    out[((long)tap * C + c0 + r) * D + n0 + col] = Cs[r][col];
  }
}

// dW[i] = sum over chunks of partial[chunk][i], in chunk order.
__global__ void sum_chunks_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                  long n_out, int chunks) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float sum = 0.f;
  for (int k = 0; k < chunks; ++k) sum += partial[(long)k * n_out + i];
  out[i] = sum;
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b, const void* g, float* partial,
                   float* out, int N, int H, int W, int C, int D, int chunks, int chunk_len,
                   int mode, cudaStream_t stream) {
  float* dst = chunks > 1 ? partial : out;
  dim3 grid((unsigned)(9 * C / BM), (unsigned)(D / BN), (unsigned)chunks);
  wgrad_conv3x3_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const T*>(g), dst, N, H, W, C, D, chunk_len, mode);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const long n_out = 9L * C * D;
  sum_chunks_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, stream>>>(partial, out, n_out,
                                                                        chunks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. mode: 0 plain conv, 1 affine, 2 affine+SiLU.
// Needs C % 64 == 0, D % 64 == 0, chunk_len % 32 == 0, chunks * chunk_len
// >= N*H*W, 16-byte aligned contiguous buffers; partial holds chunks * 9 C D
// floats when chunks > 1 (unused, may be null, when chunks == 1).
extern "C" int v2a_wgrad_conv3x3(const void* x, const void* a, const void* b, const void* g,
                                 void* partial, void* out, int N, int H, int W, int C, int D,
                                 int chunks, int chunk_len, int mode, int dtype, void* stream) {
  if (C % v2a::BM || D % v2a::BN || chunk_len % v2a::WK || chunks < 1)
    return (int)cudaErrorInvalidValue;
  if ((long)chunks * chunk_len < (long)N * H * W || (chunks > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (dtype == 1)
    return (int)v2a::launch<__nv_bfloat16>(x, a, b, g, p, o, N, H, W, C, D, chunks, chunk_len,
                                           mode, s);
  if (dtype == 0)
    return (int)v2a::launch<float>(x, a, b, g, p, o, N, H, W, C, D, chunks, chunk_len, mode, s);
  return (int)cudaErrorInvalidValue;
}
