// K12: the padded-stream PseudoConv3d with frames streamed through a 3-slot
// ring: K3's function without the skip fold. Parts x_i (B, F, H+2, Wp, C_i)
// -> y (B, F, H+2, Wp, D).
//
// Replaces the TPU kernel `fused_conv_tconv_stream`
// (v2a_tpu/ops/resblock_kernels.py:2656, body `_conv_tconv_stream_kernel`
// :2503).
//
// Per frame f: act_i(x_i) = silu(a_i * x + b_i) (or the affine alone) of the
// window in float32, rounded to the input type, with every tap outside the
// interior selected to zero (never loaded, so NaN pad rows cannot reach y);
// the parts' 3x3 convs in one float32 sum, + kbias, rounded to the input
// type into ring slot f % 3. Then frame g = f - 1: the temporal taps of
// slots g - 1, g, g + 1 (a missing neighbour is selected to zero: the ring's
// slots start uninitialised and the one past the last frame holds a stale
// frame), + tbias + emb[b], + the residual's interior, rounded once; y gets
// its interior and zero pad cols, not its pad rows; the statistics are of
// the rounded y.
//
// What bounds it on the H100: operations, as K3 (at 64^2, 256 -> 256, B = 8:
// 2.6e11 FLOP of conv taps and 8.8e10 of temporal taps against ~0.3 GB).
// Design: the TPU kernel put frames on its sequential grid and kept only a
// ring of three conv-output frames in VMEM. Here a block owns P interior
// pixels of one sample and walks f = 0..F itself: it convolves frame f for
// its pixels at all D channels (an implicit GEMM on the tensor cores, K =
// sum_i 9 C_i) into the ring in shared memory, then runs the temporal GEMM
// for frame f - 1 (K = 3 D) out of the ring. The ring holds 3 frames where
// K3 holds all F, so P can stay at 64 rows (a full wmma tile) at D <= 256;
// the conv output never reaches device memory. Statistics leave each block
// as per-tile column sums, added by a fixed-order second pass.
#include "common.cuh"

namespace v2a {
namespace {

// row stride of a ring slot in shared memory: 16 bytes of pad per row
template <typename T>
__host__ __device__ constexpr int ring_ld(int D) {
  return D + 16 / (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_tconv_stream_kernel(Part<T> p0, Part<T> p1, const float* __restrict__ kbias,
                         const T* __restrict__ tw, const float* __restrict__ tbias,
                         const float* __restrict__ emb, const T* __restrict__ res,
                         T* __restrict__ y, float* __restrict__ partial, int F, int H, int W,
                         int Wp, int D, int P, int tiles, int silu) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int ld = ring_ld<T>(D);
  T* ring = reinterpret_cast<T*>(smem);  // [3][P][ld] conv outputs, rounded
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int S = H * W, Hp = H + 2;
  const long frame = (long)Hp * Wp;
  const int tid = threadIdx.x;

  constexpr int SLOTS = (BM * BK) / (THREADS * 8);
  int rrow[SLOTS], rcg[SLOTS], rh[SLOTS], rw[SLOTS];
  bool rv[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int idx = tid + s * THREADS;
    rrow[s] = idx / (BK / 8);
    rcg[s] = (idx % (BK / 8)) * 8;
    const int sp = tile * P + rrow[s];
    rv[s] = rrow[s] < P && sp < S;
    rh[s] = rv[s] ? sp / W : 0;  // interior coordinates
    rw[s] = rv[s] ? sp % W : 0;
  }

  for (int f = 0; f <= F; ++f) {
    if (f < F) {
      // -- the conv of frame f into ring slot f % 3, all D channels --
      T* slot = ring + (long)(f % 3) * P * ld;
      const long n = (long)b * F + f;
      for (int n0 = 0; n0 < D; n0 += BN) {
        Accum<T> acc;
        acc.zero();
        for (int part = 0; part < 2; ++part) {
          const Part<T> Q = part ? p1 : p0;
          for (int tap = 0; tap < 9 && Q.C; ++tap) {
            // output padded (h+1, w+1) reads padded (h+di, w+dj)
            const int di = tap / 3, dj = tap % 3;
            for (int c0 = 0; c0 < Q.C; c0 += BK) {
#pragma unroll
              for (int s = 0; s < SLOTS; ++s) {
                const int pr = rh[s] + di, pc = rw[s] + dj;
                T* dst = &As[rrow[s]][rcg[s]];
                if (!rv[s] || pr < 1 || pr > H || pc < 1 || pc > W) {
                  zero8(dst);  // outside the interior: zero after the activation
                  continue;
                }
                float v[8];
                load8(Q.x + ((n * Hp + pr) * Wp + pc) * Q.C + c0 + rcg[s], v);
                affine8(v, Q.a + n * Q.C + c0 + rcg[s], Q.b + n * Q.C + c0 + rcg[s], silu);
                store8(dst, v);  // rounded to T before the product
              }
              load_b_tile<T>(Bs, Q.w, (long)tap * Q.C + c0, D, n0);
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
          if (r < P) slot[(long)r * ld + n0 + c] = from_f<T>(Cs[r][c] + kbias[n0 + c]);
        }
        __syncthreads();
      }
    }
    if (f < 1) continue;
    // -- the temporal taps of frame g = f - 1 out of the ring, the epilogue --
    const int g = f - 1;
    for (int n0 = 0; n0 < D; n0 += BN) {
      Accum<T> acc;
      acc.zero();
      for (int t = 0; t < 3; ++t) {
        const int ff = g + t - 1;
        const bool ok = ff >= 0 && ff < F;  // a missing neighbour is selected to zero
        const T* src = ring + (long)(ok ? ff % 3 : 0) * P * ld;
        for (int c0 = 0; c0 < D; c0 += BK) {
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            if (rv[s] && ok)
              copy8(&As[rrow[s]][rcg[s]], src + (long)rrow[s] * ld + c0 + rcg[s]);
            else
              zero8(&As[rrow[s]][rcg[s]]);
          }
          load_b_tile<T>(Bs, tw, (long)t * D + c0, D, n0);
          __syncthreads();
          acc.step(As, Bs);
          __syncthreads();
        }
      }
      acc.store(Cs);
      __syncthreads();
      for (int idx = tid; idx < BM * BN; idx += THREADS) {
        const int r = idx / BN, c = idx % BN;
        const int sp = tile * P + r;
        float qv = 0.f;
        if (r < P && sp < S) {
          const int h = sp / W, w = sp % W;
          const long o = (((long)b * F + g) * frame + (long)(h + 1) * Wp + w + 1) * D + n0 + c;
          float off = tbias[n0 + c];
          if (emb) off += emb[(long)b * D + n0 + c];
          float v = Cs[r][c] + off;
          if (res) v += to_f(res[o]);
          const T rounded = from_f<T>(v);
          y[o] = rounded;
          zero_pad_cols(y, o, w, W, Wp, D);
          qv = to_f(rounded);
        }
        Cs[r][c] = qv;  // rows past the tile count as zero in the statistics
      }
      __syncthreads();
      if (partial) {
        const int col = tid % BN, which = tid / BN;  // 0: sum, 1: sum of squares
        float sum = 0.f;
        for (int r = 0; r < P && r < BM; ++r) {
          const float v = Cs[r][col];
          sum += which ? v * v : v;
        }
        partial[((((long)b * F + g) * tiles + tile) * 2 + which) * D + n0 + col] = sum;
      }
      __syncthreads();
    }
  }
}

template <typename T>
cudaError_t launch(const void* const* pa, const int* C, const void* kbias, const void* tw,
                   const void* tbias, const void* emb, const void* res, void* y, void* partial,
                   void* stats, int B, int F, int H, int W, int Wp, int D, int P, int silu,
                   cudaStream_t stream) {
  Part<T> p[2];
  parts_from(pa, C, p);
  const int tiles = (H * W + P - 1) / P;
  const size_t dyn = (size_t)3 * P * ring_ld<T>(D) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(conv_tconv_stream_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  conv_tconv_stream_kernel<T><<<(unsigned)(B * tiles), THREADS, dyn, stream>>>(
      p[0], p[1], static_cast<const float*>(kbias), static_cast<const T*>(tw),
      static_cast<const float*>(tbias), static_cast<const float*>(emb), static_cast<const T*>(res),
      static_cast<T*>(y), static_cast<float*>(partial), F, H, W, Wp, D, P, tiles, silu);
  err = cudaGetLastError();
  if (err != cudaSuccess || !partial) return err;
  return reduce_tiles(static_cast<const float*>(partial), static_cast<float*>(stats),
                      (long)B * F, D, tiles, stream);
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. Part i: x_i (B, F, H+2, Wp, C_i), a_i / b_i
// (B*F, C_i) float32, w_i (9 C_i, D); C1 = 0 (null pointers) for one part.
// kbias, tbias (D) float32; tw (3 D, D); emb (B, D) float32; res (B, F, H+2,
// Wp, D). emb, res, partial / stats may be null; partial holds
// B*F*ceil(H*W/P)*2*D floats, stats B*F*2*D. P: pixels per block, 1..64.
// Needs C_i % 32 == 0, D % 64 == 0, Wp % 8 == 0, 16-byte aligned buffers.
extern "C" int v2a_conv_tconv_stream(const void* x0, const void* a0, const void* b0,
                                     const void* w0, const void* x1, const void* a1,
                                     const void* b1, const void* w1, const void* kbias,
                                     const void* tw, const void* tbias, const void* emb,
                                     const void* res, void* y, void* partial, void* stats, int B,
                                     int F, int H, int W, int Wp, int C0, int C1, int D, int P,
                                     int silu, int dtype, void* stream) {
  if (C0 <= 0 || C0 % v2a::BK || C1 % v2a::BK || D <= 0 || D % v2a::BN || Wp % 8 ||
      Wp < W + 2 || P <= 0 || P > v2a::BM || B <= 0 || F <= 0)
    return (int)cudaErrorInvalidValue;
  const void* pa[8] = {x0, a0, b0, w0, x1, a1, b1, w1};
  const int C[2] = {C0, C1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::launch<__nv_bfloat16>(pa, C, kbias, tw, tbias, emb, res, y, partial, stats,
                                           B, F, H, W, Wp, D, P, silu, s);
  if (dtype == 0)
    return (int)v2a::launch<float>(pa, C, kbias, tw, tbias, emb, res, y, partial, stats, B, F,
                                   H, W, Wp, D, P, silu, s);
  return (int)cudaErrorInvalidValue;
}
