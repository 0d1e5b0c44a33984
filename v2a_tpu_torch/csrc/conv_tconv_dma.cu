// K13: K3's function (the padded-stream PseudoConv3d: a multi-part
// affine+SiLU 3x3 conv, its output rounded, then the 3-tap temporal conv with
// emb, residual, the folded 1x1 skip projection and the statistics) with its
// copies overlapping its compute, on (B, F, H+2, Wp, C_i) streams ->
// (B, F, H+2, Wp, D).
//
// Replaces the TPU kernel `fused_conv_tconv_dma`
// (v2a_tpu/ops/resblock_kernels.py:2377, body `_conv_tconv_dma_kernel`
// :2152), which is K3 with hand-made double-buffered DMA: band i+1's windows
// load while band i computes, band i's output stores while band i+1 computes.
//
// The arithmetic of K3's wmma schedule before K3's Hopper redesign
// (conv_tconv_hopper.cuh), step for step: every accumulator sees 32-deep
// tensor-core steps in one fixed order (conv: part, tap, channel step;
// temporal: tap, channel step, then the skip parts), the conv output is
// rounded into shared memory before the temporal taps, the pixel tile P is
// the wrapper's `_dma_pixels` and the statistics are per-tile partials
// added in tile order. So two launches are bit-equal, and K13 agrees with
// K3 to one ulp plus the carried difference of their conv halves (their
// float32 sums run in other orders).
//
// What bounds it on the H100: operations, as K3. What differs from that
// schedule:
//   * the copies: every step's operands come through a two-stage ring in
//     shared memory filled by `cp.async` (16 bytes a thread, no registers):
//     while the tensor cores run step k, step k+1's raw input rows (64 rows x
//     32 channels of one tap), its skip rows and its weight slab are in
//     flight. The activation is applied from the raw stage into the A tile.
//     A whole pixel tile's window (7 frames x 3 rows x (P+2) cols x C_i per
//     part) does not fit twice beside the conv output at K3's shapes (at
//     64^2 with two 256-channel parts, 210 KiB a stage at P = 8), so the
//     stage is one step, as a multi-stage GEMM pipeline holds it;
//   * the grid: (sample, group of tiles), as many groups as fill the card at
//     the kernel's occupancy; a block walks its sample's tiles g, g + G, ...
//     in sequence, where K3 launches one block per tile. The stores of a
//     tile's output are not waited for: they drain while the next tile
//     computes.
#include "common.cuh"

namespace v2a {
namespace {

template <typename T>
__host__ __device__ constexpr int ys_ld(int D) {
  return D + 16 / (int)sizeof(T);
}

// byte offsets in dynamic shared memory: where the weight stages start,
// after both raw A stages (0), and where the conv output starts, after both
// weight stages (1)
template <typename T>
__host__ __device__ constexpr size_t stage_bytes(int which) {
  return which == 0 ? (size_t)2 * BM * Lds<T>::A * sizeof(T)
                    : stage_bytes<T>(0) + (size_t)2 * BK * Lds<T>::B * sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// 8 elements, 16-byte aligned at both ends
template <typename T>
__device__ __forceinline__ void cp_async8(T* dst, const T* src) {
#pragma unroll
  for (int i = 0; i < (int)(8 * sizeof(T) / 16); ++i)
    cp_async16(dst + i * 16 / (int)sizeof(T), src + i * 16 / (int)sizeof(T));
}

// the BK x BN weight slab at (k0, n0) of a row-major (K, ldb) matrix, as
// `load_b_tile`, by cp.async
template <typename T>
__device__ __forceinline__ void issue_b_tile(T (*Bs)[Lds<T>::B], const T* __restrict__ w, long k0,
                                             int ldb, int n0) {
#pragma unroll
  for (int s = 0; s < (BK * BN) / (THREADS * 8); ++s) {
    const int idx = threadIdx.x + s * THREADS;
    const int k = idx / (BN / 8);
    const int jg = (idx % (BN / 8)) * 8;
    cp_async8(&Bs[k][jg], w + (k0 + k) * ldb + n0 + jg);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_tconv_dma_kernel(Part<T> p0, Part<T> p1, const float* __restrict__ kbias,
                      const T* __restrict__ tw, const float* __restrict__ tbias,
                      const float* __restrict__ emb, const T* __restrict__ res, Skip<T> q0,
                      Skip<T> q1, const float* __restrict__ sbias, T* __restrict__ y,
                      float* __restrict__ partial, int F, int H, int W, int Wp, int D, int P,
                      int tiles, int groups, int silu) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int ldy = ys_ld<T>(D);
  const int rows = F * P;  // row r is (frame r / P, pixel tile * P + r % P)
  // the two stages: raw A rows [2][BM][Lds A] and weight slabs [2][BK][Lds B]
  // in flight, then the conv output [rows][ldy], rounded, and the tile's
  // statistics [F][2][BN]
  auto Raw = reinterpret_cast<T(*)[BM][Lds<T>::A]>(smem);
  auto Bs = reinterpret_cast<T(*)[BK][Lds<T>::B]>(smem + stage_bytes<T>(0));
  T* Ys = reinterpret_cast<T*>(smem + stage_bytes<T>(1));
  float* St = reinterpret_cast<float*>(smem + stage_bytes<T>(1) + (size_t)rows * ldy * sizeof(T));

  const int b = blockIdx.x / groups, group = blockIdx.x % groups;
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

  int tile = group;
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

  // One GEMM of `steps` 32-deep steps into acc: step k + 1's copies are
  // issued (into stage (k + 1) % 2) before step k is built and multiplied.
  auto pipeline = [&](Accum<T>& acc, int steps, auto issue, auto build) {
    acc.zero();
    issue(0, 0);
    cp_async_commit();
    for (int k = 0; k < steps; ++k) {
      if (k + 1 < steps) {
        issue(k + 1, (k + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();  // this thread's copies of step k have landed
      } else {
        cp_async_wait<0>();
      }
      build(k, k & 1);
      __syncthreads();  // the A tile and every thread's weight copies
      acc.step(As, Bs[k & 1]);
      __syncthreads();  // step k's stage is free for step k + 2
    }
  };

  const int cs0 = p0.C / BK, cs1 = p1.C / BK;
  for (; tile < tiles; tile += groups) {
    // -- phase 1: the conv output of every row, all D channels, into Ys --
    for (int chunk = 0; chunk < chunks; ++chunk) {
      decode(chunk);
      for (int n0 = 0; n0 < D; n0 += BN) {
        // step k: part, tap, channel step, in K3's order
        auto locate = [&](int k, Part<T>& Q, int& tap, int& c0) {
          const bool second = k >= 9 * cs0;
          const int kk = second ? k - 9 * cs0 : k;
          const int cs = second ? cs1 : cs0;
          Q = second ? p1 : p0;
          tap = kk / cs;
          c0 = (kk % cs) * BK;
        };
        auto inside = [&](int s, int tap) {
          const int pr = rh[s] + tap / 3, pc = rw[s] + tap % 3;
          return rv[s] && pr >= 1 && pr <= H && pc >= 1 && pc <= W;
        };
        auto issue = [&](int k, int stage) {
          Part<T> Q;
          int tap, c0;
          locate(k, Q, tap, c0);
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            if (!inside(s, tap)) continue;
            const long n = (long)b * F + rf[s];
            const int pr = rh[s] + tap / 3, pc = rw[s] + tap % 3;
            cp_async8(&Raw[stage][rrow[s]][rcg[s]],
                      Q.x + ((n * Hp + pr) * Wp + pc) * Q.C + c0 + rcg[s]);
          }
          issue_b_tile<T>(Bs[stage], Q.w, (long)tap * Q.C + c0, D, n0);
        };
        auto build = [&](int k, int stage) {
          Part<T> Q;
          int tap, c0;
          locate(k, Q, tap, c0);
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            T* dst = &As[rrow[s]][rcg[s]];
            if (!inside(s, tap)) {
              zero8(dst);  // outside the interior: zero after the activation
              continue;
            }
            const long n = (long)b * F + rf[s];
            float v[8];
            load8(&Raw[stage][rrow[s]][rcg[s]], v);
            affine8(v, Q.a + n * Q.C + c0 + rcg[s], Q.b + n * Q.C + c0 + rcg[s], silu);
            store8(dst, v);
          }
        };
        Accum<T> acc;
        pipeline(acc, 9 * (cs0 + cs1), issue, build);
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
    const int ds = D / BK, qs0 = q0.C / BK, qs1 = q1.C / BK;
    for (int n0 = 0; n0 < D; n0 += BN) {
      for (int i = tid; i < F * 2 * BN; i += THREADS) St[i] = 0.f;
      for (int chunk = 0; chunk < chunks; ++chunk) {
        decode(chunk);
        // step k: the three taps' channel steps, then each skip part's
        auto issue = [&](int k, int stage) {
          if (k < 3 * ds) {
            issue_b_tile<T>(Bs[stage], tw, (long)k * BK, D, n0);
            return;
          }
          const bool second = k >= 3 * ds + qs0;
          const Skip<T> q = second ? q1 : q0;
          const int c0 = (k - 3 * ds - (second ? qs0 : 0)) * BK;
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            if (!rv[s]) continue;
            const long pos = ((long)b * F + rf[s]) * frame + (long)(rh[s] + 1) * Wp + rw[s] + 1;
            cp_async8(&Raw[stage][rrow[s]][rcg[s]], q.x + pos * q.C + c0 + rcg[s]);
          }
          issue_b_tile<T>(Bs[stage], q.k, c0, D, n0);
        };
        auto build = [&](int k, int stage) {
          const bool tap = k < 3 * ds;
          const int t = k / ds, c0 = (k % ds) * BK;
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            T* dst = &As[rrow[s]][rcg[s]];
            if (tap) {
              const int ff = rf[s] + t - 1;
              if (rv[s] && ff >= 0 && ff < F)
                copy8(dst, Ys + (long)(ff * P + rp[s]) * ldy + c0 + rcg[s]);
              else
                zero8(dst);  // the frame padding
            } else if (rv[s]) {
              copy8(dst, &Raw[stage][rrow[s]][rcg[s]]);
            } else {
              zero8(dst);
            }
          }
        };
        Accum<T> acc;
        pipeline(acc, 3 * ds + qs0 + qs1, issue, build);
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
  const size_t dyn = stage_bytes<T>(1) + (size_t)F * P * ys_ld<T>(D) * sizeof(T) +
                     (size_t)F * 2 * BN * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(conv_tconv_dma_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  // as many tile groups per sample as fill every SM at this occupancy
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_tconv_dma_kernel<T>,
                                                           THREADS, dyn)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int groups = (per_sm * sms + B - 1) / B;
  groups = groups < tiles ? groups : tiles;
  conv_tconv_dma_kernel<T><<<(unsigned)(B * groups), THREADS, dyn, stream>>>(
      p[0], p[1], static_cast<const float*>(kbias), static_cast<const T*>(tw),
      static_cast<const float*>(tbias), static_cast<const float*>(emb), static_cast<const T*>(res),
      q[0], q[1], static_cast<const float*>(sbias), static_cast<T*>(y),
      static_cast<float*>(partial), F, H, W, Wp, D, P, tiles, groups, silu);
  err = cudaGetLastError();
  if (err != cudaSuccess || !partial) return err;
  return reduce_tiles(static_cast<const float*>(partial), static_cast<float*>(stats),
                      (long)B * F, D, tiles, stream);
}

}  // namespace
}  // namespace v2a

// K3's C interface (csrc/conv_tconv_padded.cu), the same arguments: dtype 0 =
// float32, 1 = bfloat16; part i: x_i (B, F, H+2, Wp, C_i), a_i / b_i (B*F,
// C_i) float32, w_i (9 C_i, D); C1 = 0 for one part; kbias, tbias (D) float32;
// tw (3 D, D); emb (B, D) float32; res (B, F, H+2, Wp, D); skip part i: s_i
// (B, F, H+2, Wp, Cs_i), k_i (Cs_i, D), sbias (D) float32; partial
// B*F*ceil(H*W/P)*2*D floats, stats B*F*2*D. Needs C_i % 32 == 0,
// Cs_i % 32 == 0, D % 64 == 0, Wp % 8 == 0, 16-byte aligned buffers.
extern "C" int v2a_conv_tconv_dma(const void* x0, const void* a0, const void* b0, const void* w0,
                                  const void* x1, const void* a1, const void* b1, const void* w1,
                                  const void* kbias, const void* tw, const void* tbias,
                                  const void* emb, const void* res, const void* s0,
                                  const void* k0, const void* s1, const void* k1,
                                  const void* sbias, void* y, void* partial, void* stats, int B,
                                  int F, int H, int W, int Wp, int C0, int C1, int D, int Cs0,
                                  int Cs1, int P, int silu, int dtype, void* stream) {
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
