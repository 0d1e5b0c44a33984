// K14: y = conv3x3_same(x) + bias on (N, H, W, C) -> (N, H, W, D) by
// Winograd F(2x2, 3x3), H and W even: K10's function with 16/9 the products
// of a direct conv spread over 4x fewer rows (2.25x fewer multiplies).
//
// Replaces the TPU kernel `winograd_conv3x3`
// (v2a_tpu/ops/resblock_kernels.py:3163, body `_winograd_kernel` :3062).
//
// Rounding, as the TPU body rounds (T = x's type). Per 2x2 output patch, d is
// its 4x4 input patch (rows and cols -1 .. 2 around it, zero outside the
// frame), in float32:
//   t_a = row combo a of d      (d0 - d2, d1 + d2, d2 - d1, d1 - d3)
//   U_ab = T(col combo b of t_a) (the same four combos over the cols)
//   M_ab = U_ab @ W_ab           the 16 products, float32 sums, W_ab = T(G g G^T)
//   Y_rc = sum over (a, b) in order of +-M_ab (A^T rows [1,1,1,0], [0,1,-1,-1]),
//          in float32, the first term taken as it is
//   y = T(Y_rc + bias)           one rounding
//
// What bounds it on the H100: operations (at 128^2 x 128 -> 128, N = 56:
// 6.6e10 FLOP of transform-domain products against ~0.37 GB, 0.067 against
// 0.11 ms: at this width it is bound by bytes; at 64^2 x 256 and 32^2 x 384
// by operations). Design: a block owns 64 consecutive 2x2 output patches of
// one image x 64 output channels. For each of the 16 components (a, b) in
// order it runs the (64 patches, C) x (C, 64) product on the tensor cores
// (wmma, float32 accumulators): each 32-channel step gathers the four input
// values each patch needs for that component straight from device memory
// (L1 / L2 serve the overlaps), combines them in float32 and rounds them
// into the A tile. The product goes to shared memory and is added, with its
// sign, into four float32 output-parity tiles (64 KiB of shared memory), in
// the TPU body's order; after the 16th, bias, one rounding, and the patch
// is scattered to its 2x2 pixels. The gather reads each input value 4 times
// per component where K10 reads a band once: the cost of this simple form.
#include "common.cuh"

namespace v2a {
namespace {

// row (and col) combo k of a 4-vector: v[I1[k]] + SG[k] * v[I2[k]]
__constant__ int I1[4] = {0, 1, 2, 1};
__constant__ int I2[4] = {2, 2, 1, 3};
__constant__ float SG[4] = {-1.f, 1.f, -1.f, -1.f};
// A^T: output parity r takes component a with this sign (0: not at all)
__constant__ float AT[2][4] = {{1.f, 1.f, 1.f, 0.f}, {0.f, 1.f, -1.f, -1.f}};

template <typename T>
__device__ __forceinline__ void load8_or_zero(const T* __restrict__ x, int r, int c, int H,
                                              int W, int C, float v[8]) {
  if (r < 0 || r >= H || c < 0 || c >= W) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
    return;
  }
  load8(x + ((long)r * W + c) * C, v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
winograd_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                const float* __restrict__ bias, T* __restrict__ y, int H, int W, int C, int D,
                int tiles) {
  extern __shared__ __align__(16) float Ys[];  // [4 parities][BM][BN]
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int n = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int PW = W / 2, P = (H / 2) * PW;
  const T* xn = x + (long)n * H * W * C;

  constexpr int SLOTS = (BM * BK) / (THREADS * 8);
  int rrow[SLOTS], rcg[SLOTS], rr0[SLOTS], rc0[SLOTS];
  bool rv[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int idx = tid + s * THREADS;
    rrow[s] = idx / (BK / 8);
    rcg[s] = (idx % (BK / 8)) * 8;
    const int p = tile * BM + rrow[s];
    rv[s] = p < P;
    rr0[s] = rv[s] ? 2 * (p / PW) - 1 : 0;  // the patch's input row / col -1
    rc0[s] = rv[s] ? 2 * (p % PW) - 1 : 0;
  }

  for (int ab = 0; ab < 16; ++ab) {
    const int a = ab / 4, b = ab % 4;
    Accum<T> acc;
    acc.zero();
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        T* dst = &As[rrow[s]][rcg[s]];
        if (!rv[s]) {
          zero8(dst);
          continue;
        }
        const int r1 = rr0[s] + I1[a], r2 = rr0[s] + I2[a];
        const int k1 = rc0[s] + I1[b], k2 = rc0[s] + I2[b];
        float d11[8], d21[8], d12[8], d22[8];
        const T* xc = xn + c0 + rcg[s];
        load8_or_zero(xc, r1, k1, H, W, C, d11);
        load8_or_zero(xc, r2, k1, H, W, C, d21);
        load8_or_zero(xc, r1, k2, H, W, C, d12);
        load8_or_zero(xc, r2, k2, H, W, C, d22);
        float u[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float t1 = __fadd_rn(d11[i], SG[a] * d21[i]);  // t_a at col k1
          const float t2 = __fadd_rn(d12[i], SG[a] * d22[i]);  // t_a at col k2
          u[i] = __fadd_rn(t1, SG[b] * t2);
        }
        store8(dst, u);  // U_ab, rounded to T
      }
      load_b_tile<T>(Bs, wt, (long)ab * C + c0, D, n0);
      __syncthreads();
      acc.step(As, Bs);
      __syncthreads();
    }
    acc.store(Cs);
    __syncthreads();
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      const float m = Cs[r][c];
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
#pragma unroll
        for (int pc = 0; pc < 2; ++pc) {
          const float sg = AT[pr][a] * AT[pc][b];
          if (sg == 0.f) continue;
          float* yv = Ys + ((pr * 2 + pc) * BM + r) * BN + c;
          const float contrib = sg > 0.f ? m : -m;
          *yv = (a == pr && b == pc) ? contrib : __fadd_rn(*yv, contrib);
        }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < 4 * BM * BN; idx += THREADS) {
    const int par = idx / (BM * BN), r = (idx / BN) % BM, c = idx % BN;
    const int p = tile * BM + r;
    if (p >= P) continue;
    const int oh = 2 * (p / PW) + par / 2, ow = 2 * (p % PW) + par % 2;
    y[(((long)n * H + oh) * W + ow) * D + n0 + c] = from_f<T>(__fadd_rn(Ys[idx], bias[n0 + c]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wt, const void* bias, void* y, int N, int H, int W,
                   int C, int D, cudaStream_t stream) {
  const int tiles = ((H / 2) * (W / 2) + BM - 1) / BM;
  const size_t dyn = (size_t)4 * BM * BN * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(winograd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(N * tiles), (unsigned)(D / BN));
  winograd_kernel<T><<<grid, THREADS, dyn, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), static_cast<const float*>(bias),
      static_cast<T*>(y), H, W, C, D, tiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. x (N, H, W, C), wt (16 C, D): the 16
// transform-domain weights (component a*4+b major), rounded to x's type;
// bias (D) float32; y (N, H, W, D). Needs even H and W, C % 32 == 0,
// D % 64 == 0, 16-byte aligned contiguous buffers.
extern "C" int v2a_winograd_conv3x3(const void* x, const void* wt, const void* bias, void* y,
                                    int N, int H, int W, int C, int D, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || C <= 0 || C % v2a::BK || D <= 0 ||
      D % v2a::BN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)v2a::launch<__nv_bfloat16>(x, wt, bias, y, N, H, W, C, D, s);
  if (dtype == 0) return (int)v2a::launch<float>(x, wt, bias, y, N, H, W, C, D, s);
  return (int)cudaErrorInvalidValue;
}
