// K3: the whole padded-stream PseudoConv3d in one kernel: K4a (a multi-part
// affine+SiLU 3x3 conv) and then K4b (the 3-tap temporal conv with emb,
// residual, the folded 1x1 skip projection and the statistics), on
// (B, F, H+2, Wp, C_i) streams -> (B, F, H+2, Wp, D).
//
// Replaces the TPU kernel `fused_conv_tconv_padded`
// (v2a_tpu/ops/resblock_kernels.py:1978, body `_conv_tconv_kernel` :1592).
//
// The conv output of each frame is rounded to the input type before the
// temporal taps, as K4a's stored output is, so K3 equals K4a -> K4b up to the
// order of float32 sums. Pad values of the inputs are never read (the conv
// skips halo taps, the residual and skip streams are read at interior
// positions only); y gets its interior and zero pad cols, not its pad rows.
//
// What bounds it on the H100: operations (at 128^2, 128 -> 128 with the
// residual, B = 8: 2.7e11 FLOP of conv taps and 9.0e10 of temporal taps,
// 0.36 ms at 989 TF/s, against ~0.76 GB, 0.23 ms). Design: the temporal
// taps mix all D channels of three frames, so a block owns P pixels of one
// sample for ALL F frames. Phase 1 computes their conv output (an implicit
// GEMM over the F*P (frame, pixel) rows, K = sum_i 9*C_i, 64 channels at a
// time on the tensor cores) into shared memory, rounded; it never reaches
// device memory. Phase 2 runs the temporal GEMM over the same rows with
// K = 3*D read from shared memory (+ the skip channels from device memory)
// and writes y and per-tile statistics, which a second pass adds in tile
// order (deterministic). Shared memory bounds P (the wrapper's `_k3_pixels`
// keeps F*P*D elements within 64 KiB, two blocks per SM), so the tensor
// cores are fed 64-row tiles out of a small working set.
#include "common.cuh"

namespace v2a {
namespace {

// row stride of the conv output in shared memory: 16 bytes of pad per row
template <typename T>
__host__ __device__ constexpr int ys_ld(int D) {
  return D + 16 / (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_tconv_padded_kernel(Part<T> p0, Part<T> p1, const float* __restrict__ kbias,
                         const T* __restrict__ tw, const float* __restrict__ tbias,
                         const float* __restrict__ emb, const T* __restrict__ res, Skip<T> q0,
                         Skip<T> q1, const float* __restrict__ sbias, T* __restrict__ y,
                         float* __restrict__ partial, int F, int H, int W, int Wp, int D, int P,
                         int tiles, int silu) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int ldy = ys_ld<T>(D);
  const int rows = F * P;  // row r is (frame r / P, pixel tile * P + r % P)
  T* Ys = reinterpret_cast<T*>(smem);  // [rows][ldy] conv output, rounded
  float* St = reinterpret_cast<float*>(smem + (size_t)rows * ldy * sizeof(T));  // [F][2][BN]

  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int S = H * W, Hp = H + 2;
  const long frame = (long)Hp * Wp;
  const int tid = threadIdx.x;
  const int chunks = (rows + BM - 1) / BM;

  constexpr int SLOTS = (BM * BK) / (THREADS * 8);
  int rrow[SLOTS], rcg[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int idx = tid + s * THREADS;
    rrow[s] = idx / (BK / 8);
    rcg[s] = (idx % (BK / 8)) * 8;
  }

  // the (frame, interior row, interior col) of each gather slot in a chunk
  int rf[SLOTS], rp[SLOTS], rh[SLOTS], rw[SLOTS];
  bool rv[SLOTS];
  auto decode = [&](int chunk) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int r = chunk * BM + rrow[s];
      const int sp = tile * P + r % P;
      rv[s] = r < rows && sp < S;
      rf[s] = rv[s] ? r / P : 0;
      rp[s] = r % P;
      rh[s] = rv[s] ? sp / W : 0;
      rw[s] = rv[s] ? sp % W : 0;
    }
  };

  // -- phase 1: the conv output of every row, all D channels, into Ys --
  for (int chunk = 0; chunk < chunks; ++chunk) {
    decode(chunk);
    for (int n0 = 0; n0 < D; n0 += BN) {
      Accum<T> acc;
      acc.zero();
      for (int part = 0; part < 2; ++part) {
        const Part<T> Q = part ? p1 : p0;
        for (int tap = 0; tap < 9 && Q.C; ++tap) {
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
              const long n = (long)b * F + rf[s];
              float v[8];
              load8(Q.x + ((n * Hp + pr) * Wp + pc) * Q.C + c0 + rcg[s], v);
              affine8(v, Q.a + n * Q.C + c0 + rcg[s], Q.b + n * Q.C + c0 + rcg[s], silu);
              store8(dst, v);
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
        const int rr = idx / BN, c = idx % BN;
        const int r = chunk * BM + rr;
        if (r < rows) Ys[(long)r * ldy + n0 + c] = from_f<T>(Cs[rr][c] + kbias[n0 + c]);
      }
      __syncthreads();
    }
  }

  // -- phase 2: the temporal taps out of Ys, the skip fold, the epilogue --
  for (int n0 = 0; n0 < D; n0 += BN) {
    for (int i = tid; i < F * 2 * BN; i += THREADS) St[i] = 0.f;
    for (int chunk = 0; chunk < chunks; ++chunk) {
      decode(chunk);
      Accum<T> acc;
      acc.zero();
      for (int t = 0; t < 3; ++t) {
        for (int c0 = 0; c0 < D; c0 += BK) {
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            const int ff = rf[s] + t - 1;
            if (rv[s] && ff >= 0 && ff < F)
              copy8(&As[rrow[s]][rcg[s]], Ys + (long)(ff * P + rp[s]) * ldy + c0 + rcg[s]);
            else
              zero8(&As[rrow[s]][rcg[s]]);  // the frame padding
          }
          load_b_tile<T>(Bs, tw, (long)t * D + c0, D, n0);
          __syncthreads();
          acc.step(As, Bs);
          __syncthreads();
        }
      }
      for (int part = 0; part < 2; ++part) {
        const Skip<T> q = part ? q1 : q0;
        for (int c0 = 0; c0 < q.C; c0 += BK) {
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            if (rv[s]) {
              const long pos = ((long)b * F + rf[s]) * frame + (long)(rh[s] + 1) * Wp + rw[s] + 1;
              copy8(&As[rrow[s]][rcg[s]], q.x + pos * q.C + c0 + rcg[s]);
            } else {
              zero8(&As[rrow[s]][rcg[s]]);
            }
          }
          load_b_tile<T>(Bs, q.k, c0, D, n0);
          __syncthreads();
          acc.step(As, Bs);
          __syncthreads();
        }
      }
      acc.store(Cs);
      __syncthreads();
      for (int idx = tid; idx < BM * BN; idx += THREADS) {
        const int rr = idx / BN, c = idx % BN;
        const int r = chunk * BM + rr;
        const int sp = tile * P + r % P;
        float qv = 0.f;
        if (r < rows && sp < S) {
          const int f = r / P, h = sp / W, w = sp % W;
          const long o = (((long)b * F + f) * frame + (long)(h + 1) * Wp + w + 1) * D + n0 + c;
          float off = tbias[n0 + c];
          if (emb) off += emb[(long)b * D + n0 + c];
          float v = Cs[rr][c] + off;
          if (sbias) v += sbias[n0 + c];
          if (res) v += to_f(res[o]);
          const T rounded = from_f<T>(v);
          y[o] = rounded;
          zero_pad_cols(y, o, w, W, Wp, D);
          qv = to_f(rounded);
        }
        Cs[rr][c] = qv;  // rows past the tile count as zero in the statistics
      }
      __syncthreads();
      if (partial) {
        // thread (col, which) owns St[f][which][col]: a running sum per frame
        const int col = tid % BN, which = tid / BN;
        int fcur = -1;
        float run = 0.f;
        for (int rr = 0; rr < BM; ++rr) {
          const int r = chunk * BM + rr;
          if (r >= rows) break;
          if (r / P != fcur) {
            if (fcur >= 0) St[(fcur * 2 + which) * BN + col] += run;
            fcur = r / P;
            run = 0.f;
          }
          const float v = Cs[rr][col];
          run += which ? v * v : v;
        }
        if (fcur >= 0) St[(fcur * 2 + which) * BN + col] += run;
      }
      __syncthreads();
    }
    if (partial) {
      for (int i = tid; i < F * 2 * BN; i += THREADS) {
        const int f = i / (2 * BN), which = (i / BN) % 2, col = i % BN;
        partial[((((long)b * F + f) * tiles + tile) * 2 + which) * D + n0 + col] = St[i];
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* const* pa, const int* C, const void* kbias, const void* tw,
                   const void* tbias, const void* emb, const void* res, const void* const* sk,
                   const int* Cs, const void* sbias, void* y, void* partial, void* stats, int B,
                   int F, int H, int W, int Wp, int D, int P, int silu, cudaStream_t stream) {
  Part<T> p[2];
  Skip<T> q[2];
  parts_from(pa, C, p);
  skips_from(sk, Cs, q);
  const int tiles = (H * W + P - 1) / P;
  const size_t dyn = (size_t)F * P * ys_ld<T>(D) * sizeof(T) + (size_t)F * 2 * BN * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(conv_tconv_padded_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  conv_tconv_padded_kernel<T><<<(unsigned)(B * tiles), THREADS, dyn, stream>>>(
      p[0], p[1], static_cast<const float*>(kbias), static_cast<const T*>(tw),
      static_cast<const float*>(tbias), static_cast<const float*>(emb), static_cast<const T*>(res),
      q[0], q[1], static_cast<const float*>(sbias), static_cast<T*>(y),
      static_cast<float*>(partial), F, H, W, Wp, D, P, tiles, silu);
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
// Wp, D); skip part i: s_i (B, F, H+2, Wp, Cs_i), k_i (Cs_i, D), sbias (D)
// float32 with any skip part. emb, res, skips, partial / stats may be null;
// partial holds B*F*ceil(H*W/P)*2*D floats, stats B*F*2*D. P: pixels per
// block. Needs C_i % 32 == 0, Cs_i % 32 == 0, D % 64 == 0, Wp % 8 == 0,
// 16-byte aligned buffers.
extern "C" int v2a_conv_tconv_padded(const void* x0, const void* a0, const void* b0,
                                     const void* w0, const void* x1, const void* a1,
                                     const void* b1, const void* w1, const void* kbias,
                                     const void* tw, const void* tbias, const void* emb,
                                     const void* res, const void* s0, const void* k0,
                                     const void* s1, const void* k1, const void* sbias, void* y,
                                     void* partial, void* stats, int B, int F, int H, int W,
                                     int Wp, int C0, int C1, int D, int Cs0, int Cs1, int P,
                                     int silu, int dtype, void* stream) {
  if (C0 <= 0 || C0 % v2a::BK || C1 % v2a::BK || D % v2a::BN || Cs0 % v2a::BK ||
      Cs1 % v2a::BK || Wp % 8 || Wp < W + 2 || P <= 0)
    return (int)cudaErrorInvalidValue;
  if ((Cs0 || Cs1) && !sbias) return (int)cudaErrorInvalidValue;
  const void* pa[8] = {x0, a0, b0, w0, x1, a1, b1, w1};
  const int C[2] = {C0, C1};
  const void* sk[4] = {s0, k0, s1, k1};
  const int Cs[2] = {Cs0, Cs1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::launch<__nv_bfloat16>(pa, C, kbias, tw, tbias, emb, res, sk, Cs, sbias, y,
                                           partial, stats, B, F, H, W, Wp, D, P, silu, s);
  if (dtype == 0)
    return (int)v2a::launch<float>(pa, C, kbias, tw, tbias, emb, res, sk, Cs, sbias, y, partial,
                                   stats, B, F, H, W, Wp, D, P, silu, s);
  return (int)cudaErrorInvalidValue;
}
