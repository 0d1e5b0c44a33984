// K9: spatial self-attention of a (B*F)-folded padded stream,
// x (N, H+2, Wp, C) -> y (N, H+2, Wp, C) with every pad position zero, and the
// per-sample interior sum / sum of squares of the unrounded output.
//
// Replaces the TPU kernel `fused_spatial_attention_padded`
// (v2a_tpu/ops/resblock_kernels.py:2962, body `_attn_padded_kernel` :2855).
//
// Rounding, as the TPU body rounds (T = the stream's type):
//   xn = T(x * a + b)                       per (sample, channel) affine
//   qkv = T(xn @ Wqkv + bqkv)               float32 sum, + float32 bias
//   per head h (legacy layout, q / k / v at 96 h + 0 / 32 / 64):
//     l = dot(q, k) * s2, s2 = float(ch^-1/2) applied AFTER the dot
//     p = T(exp(l - max_k l) / sum_k exp(l - max_k l))
//     o = T(p @ v)
//   y = T(x + (o @ Wproj + bproj))          residual added in float32, once
//   stats: sums of the float32 y before that rounding.
// The TPU kernel masks pad keys with an additive -1e30: their weight is
// exactly zero, so they are left out here, and so are the pad queries, whose
// outputs the TPU kernel zeroes. Only interior tokens are read (pad values,
// NaN included, never reach y).
//
// What bounds it on the H100: operations (at 16^2 x 512, N = 56: 38 GFLOP,
// 80% of it in the two GEMMs, against 50 MB of stream in and out). Design,
// four launches and the statistics pass:
//   1. zero the pad positions of y;
//   2. QKV: the tile GEMM of common.cuh over (interior tokens, C) x (C, 3C),
//      the affine applied in the gather, into a (N * S, 3C) scratch; tiles
//      past C or 3C (C % 64 != 0) are masked;
//   3. attention: a block per (64 queries, head, sample) holds its queries
//      in shared memory and walks the keys in chunks of 64, K and V of a
//      chunk in shared memory (float32), so any token count fits. Pass 1
//      over the chunks: each lane's running row max and row sum over its
//      keys, combined across the warp (the max is exact, the sum is summed
//      in another order than the plain version's). Pass 2: the logits again,
//      the probabilities ex / sum rounded to T (an online-softmax rescale of
//      the output would round differently), P @ V summed in float32 and each
//      head's output rounded once, into a (N * S, C) scratch. Any head width
//      ch that divides C: its channels pass through shared memory in slices
//      of a template width CS (16, 32, 64 or 128, the next one up from ch;
//      128-wide slices past 128), the lanes past ch masked out of every
//      sum; the logits add q . k over the slices in channel order, and
//      P @ V is written per slice (one more logits pass per extra slice);
//   4. projection: the tile GEMM over (tokens, C) x (C, C) whose epilogue adds
//      the bias and the residual in float32, writes y and the tile's column
//      sums of y and y^2 (tiles never straddle two samples);
//   5. `reduce_tiles` adds the tiles in order (deterministic, no atomics).
#include <cmath>

#include "common.cuh"

namespace v2a {
namespace {

constexpr int QB = 64;         // query rows per attention block
constexpr int KC = 64;         // keys per shared-memory chunk
constexpr int ATT_WARPS = 8;   // warps per attention block
constexpr int QPW = QB / ATT_WARPS;  // queries per warp

template <typename T>
__global__ void zero_pads_kernel(T* __restrict__ y, long n_vec, int H, int W, int Hp, int Wp,
                                 int C) {
  const int c8 = C / 8;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += (long)gridDim.x * blockDim.x) {
    const long pos = i / c8;
    const int rc = (int)(pos % ((long)Hp * Wp));
    const int r = rc / Wp, col = rc % Wp;
    if (r >= 1 && r <= H && col >= 1 && col <= W) continue;
    zero8(y + pos * C + (i % c8) * 8);
  }
}

// load_b_tile with the rows past K and the columns past ldw zero-filled.
template <typename T>
__device__ __forceinline__ void load_b_tile_masked(T (*Bs)[Lds<T>::B], const T* __restrict__ w,
                                                   int k0, int K, int ldw, int n0) {
#pragma unroll
  for (int s = 0; s < (BK * BN) / (THREADS * 8); ++s) {
    const int idx = threadIdx.x + s * THREADS;
    const int k = idx / (BN / 8);
    const int jg = (idx % (BN / 8)) * 8;
    if (k0 + k < K && n0 + jg < ldw)
      copy8(&Bs[k][jg], w + (long)(k0 + k) * ldw + n0 + jg);
    else
      zero8(&Bs[k][jg]);
  }
}

// The two GEMMs over the interior tokens of each sample: block (sample *
// tiles + tile, column tile). PROJ = false: A = T(x * a + b) gathered from the
// padded x, out = qkv (N * S, ldw). PROJ = true: A = att (N * S, C), out = y
// (padded) = T(x + A @ w + bias), and the tile's column sums into partial.
// C and ldw are multiples of 8; the K steps and column tiles past them are
// zero-filled.
template <typename T, bool PROJ>
__global__ void __launch_bounds__(THREADS)
attn_gemm_kernel(const T* __restrict__ src, const float* __restrict__ a,
                 const float* __restrict__ b, const T* __restrict__ w,
                 const float* __restrict__ bias, const T* __restrict__ x, T* __restrict__ out,
                 float* __restrict__ partial, int S, int W, int Hp, int Wp, int C, int ldw,
                 int tiles) {
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int n = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int s0 = tile * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  constexpr int SLOTS = (BM * BK) / (THREADS * 8);
  int rrow[SLOTS], rcg[SLOTS];
  long roff[SLOTS];
  bool rvalid[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int idx = tid + s * THREADS;
    rrow[s] = idx / (BK / 8);
    rcg[s] = (idx % (BK / 8)) * 8;
    const int tok = s0 + rrow[s];
    rvalid[s] = tok < S;
    const int t = rvalid[s] ? tok : 0;
    roff[s] = PROJ ? ((long)n * S + t) * C
                   : (((long)n * Hp + 1 + t / W) * Wp + 1 + t % W) * C;
  }

  Accum<T> acc;
  acc.zero();
  for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      T* dst = &As[rrow[s]][rcg[s]];
      if (!rvalid[s] || c0 + rcg[s] >= C) {
        zero8(dst);
        continue;
      }
      if (PROJ) {
        copy8(dst, src + roff[s] + c0 + rcg[s]);
        continue;
      }
      float v[8];
      load8(src + roff[s] + c0 + rcg[s], v);
      const long aoff = (long)n * C + c0 + rcg[s];
      affine8(v, a + aoff, b + aoff, false);
      store8(dst, v);  // xn, rounded to T before the product
    }
    load_b_tile_masked<T>(Bs, w, c0, C, ldw, n0);
    __syncthreads();
    acc.step(As, Bs);
    __syncthreads();
  }
  acc.store(Cs);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int tok = s0 + r;
    if (tok >= S || n0 + c >= ldw) continue;
    const float p = __fadd_rn(Cs[r][c], bias[n0 + c]);
    if (!PROJ) {
      out[((long)n * S + tok) * ldw + n0 + c] = from_f<T>(p);
      continue;
    }
    const long o = (((long)n * Hp + 1 + tok / W) * Wp + 1 + tok % W) * C + n0 + c;
    const float yv = __fadd_rn(to_f(x[o]), p);
    out[o] = from_f<T>(yv);
    Cs[r][c] = yv;  // the unrounded output, for the statistics
  }
  if (!PROJ || partial == nullptr) return;
  __syncthreads();
  if (tid < 2 * BN) {
    const int c = tid % BN, which = tid / BN;
    if (n0 + c >= C) return;
    float sum = 0.f;
    for (int r = 0; r < BM && s0 + r < S; ++r) {
      const float v = Cs[r][c];
      sum = __fadd_rn(sum, which ? __fmul_rn(v, v) : v);
    }
    partial[(((long)n * tiles + tile) * 2 + which) * C + n0 + c] = sum;
  }
}

// The lanes of a warp over a slice of CS output channels: G lanes per key
// group, KS key groups (CS < 32 splits the keys), CPL channels per lane.
template <int CS>
struct HeadLanes {
  static constexpr int G = CS < 32 ? CS : 32;
  static constexpr int KS = 32 / G;
  static constexpr int CPL = CS / G;
};

// Block (query tile, head, sample); qkv (N * S, 3C) -> att (N * S, C). The
// head's ch channels pass through shared memory in slices of CS (the
// template width: the next of 16, 32, 64, 128 up from ch, or 128-wide
// slices past 128); lanes past the slice's last channel hold zeros and take
// no part in a sum. The logits sum q . k over the channels in order, slice
// after slice, so any ch gives the single pass's float32 sum.
template <typename T, int CS>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ att, int S, int C, int ch,
                 float s2) {
  using L = HeadLanes<CS>;
  constexpr int K_LD = CS + 1;  // K rows padded: lane j reads row j, bank (j + c) % 32
  constexpr int JL = KC / 32;   // keys of a chunk per lane
  extern __shared__ float smem[];
  float* Qs = smem;                    // [QB][CS]
  float* Ks = Qs + QB * CS;            // [KC][K_LD]
  float* Vs = Ks + KC * K_LD;          // [KC][CS]
  float* P = Vs + KC * CS;             // [ATT_WARPS][KC]
  const int q0 = blockIdx.x * QB, hd = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long ld = 3L * C;
  const T* base = qkv + (long)n * S * ld + (long)hd * 3 * ch;
  const int slices = (ch + CS - 1) / CS;

  // slice sl of q (at 0), k (at ch) or v (at 2 ch) of rows r0.. into dst
  auto load = [&](float* dst, int dst_ld, int r0, int rows, int at, int sl) {
    for (int i = threadIdx.x; i < rows * CS; i += blockDim.x) {
      const int r = i / CS, c = i % CS, cc = sl * CS + c;
      dst[r * dst_ld + c] = r0 + r < S && cc < ch ? to_f(base[(long)(r0 + r) * ld + at + cc]) : 0.f;
    }
  };
  if (slices == 1) load(Qs, CS, q0, QB, 0, 0);

  // this warp's logits against the keys j0 + lane + 32 u of a chunk; with
  // vsl >= 0 the chunk's V slice vsl is loaded beside the last K slice
  float lg[QPW][JL];
  auto logits = [&](int j0, int vsl) {
#pragma unroll
    for (int i = 0; i < QPW; ++i)
#pragma unroll
      for (int u = 0; u < JL; ++u) lg[i][u] = 0.f;
    for (int sl = 0; sl < slices; ++sl) {
      __syncthreads();  // every read of the previous slice or chunk is done
      if (slices > 1) load(Qs, CS, q0, QB, 0, sl);
      load(Ks, K_LD, j0, KC, ch, sl);
      if (vsl >= 0 && sl == slices - 1) load(Vs, CS, j0, KC, 2 * ch, vsl);
      __syncthreads();
      const int cn = min(CS, ch - sl * CS);
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const float* q = Qs + (warp + i * ATT_WARPS) * CS;
#pragma unroll
        for (int u = 0; u < JL; ++u) {
          const float* k = Ks + (lane + 32 * u) * K_LD;
          float dot = lg[i][u];
          if (cn == CS) {
#pragma unroll
            for (int c = 0; c < CS; ++c) dot = __fadd_rn(dot, __fmul_rn(q[c], k[c]));
          } else {
            for (int c = 0; c < cn; ++c) dot = __fadd_rn(dot, __fmul_rn(q[c], k[c]));
          }
          lg[i][u] = dot;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < QPW; ++i)
#pragma unroll
      for (int u = 0; u < JL; ++u) lg[i][u] = __fmul_rn(lg[i][u], s2);
  };

  // pass 1: each lane's running max and sum of exp over its keys
  float mx[QPW], sm[QPW];
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    mx[i] = -INFINITY;
    sm[i] = 0.f;
  }
  for (int j0 = 0; j0 < S; j0 += KC) {
    logits(j0, -1);
    const int kc = min(KC, S - j0);
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      if (q0 + warp + i * ATT_WARPS >= S) continue;
#pragma unroll
      for (int u = 0; u < JL; ++u) {
        if (lane + 32 * u >= kc) continue;
        const float l = lg[i][u];
        if (l > mx[i]) {
          sm[i] = __fadd_rn(__fmul_rn(sm[i], expf(__fsub_rn(mx[i], l))), 1.f);
          mx[i] = l;
        } else {
          sm[i] = __fadd_rn(sm[i], expf(__fsub_rn(l, mx[i])));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mx[i], o);
      const float s2v = __shfl_xor_sync(0xffffffffu, sm[i], o);
      const float m = fmaxf(mx[i], m2);
      const float a = mx[i] == -INFINITY ? 0.f : __fmul_rn(sm[i], expf(__fsub_rn(mx[i], m)));
      const float b = m2 == -INFINITY ? 0.f : __fmul_rn(s2v, expf(__fsub_rn(m2, m)));
      sm[i] = __fadd_rn(a, b);
      mx[i] = m;
    }
  }

  // pass 2, per output slice: p = T(ex / sum), o = sum_j p_j v_j in float32
  const int group = lane / L::G, slot = lane % L::G;
  float* row = P + warp * KC;
  for (int osl = 0; osl < slices; ++osl) {
    float acc[QPW][L::CPL];
#pragma unroll
    for (int i = 0; i < QPW; ++i)
#pragma unroll
      for (int u = 0; u < L::CPL; ++u) acc[i][u] = 0.f;
    for (int j0 = 0; j0 < S; j0 += KC) {
      logits(j0, osl);  // its first barrier also closes the previous chunk's V reads
      const int kc = min(KC, S - j0);
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        if (q0 + warp + i * ATT_WARPS >= S) continue;
#pragma unroll
        for (int u = 0; u < JL; ++u)
          if (lane + 32 * u < kc)
            row[lane + 32 * u] =
                to_f(from_f<T>(__fdiv_rn(expf(__fsub_rn(lg[i][u], mx[i])), sm[i])));
        __syncwarp();
        for (int j = group; j < kc; j += L::KS) {
          const float p = row[j];
#pragma unroll
          for (int u = 0; u < L::CPL; ++u)
            acc[i][u] = __fadd_rn(acc[i][u], __fmul_rn(p, Vs[j * CS + slot + u * L::G]));
        }
        __syncwarp();
      }
    }
    const int cn = min(CS, ch - osl * CS);
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
#pragma unroll
      for (int u = 0; u < L::CPL; ++u)
#pragma unroll
        for (int o = L::G; o < 32; o <<= 1)
          acc[i][u] = __fadd_rn(acc[i][u], __shfl_xor_sync(0xffffffffu, acc[i][u], o));
      const int qi = q0 + warp + i * ATT_WARPS;
      if (qi < S && group == 0) {
#pragma unroll
        for (int u = 0; u < L::CPL; ++u) {
          const int cc = slot + u * L::G;
          if (cc < cn)
            att[((long)n * S + qi) * C + (long)hd * ch + osl * CS + cc] = from_f<T>(acc[i][u]);
        }
      }
    }
  }
}

template <int CS>
size_t attention_smem() {
  return (size_t)(QB * CS + KC * (CS + 1) + KC * CS + ATT_WARPS * KC) * sizeof(float);
}

template <typename T, int CS>
cudaError_t launch_attention(const T* qkv, T* att, int N, int S, int C, int ch, float s2,
                             cudaStream_t stream) {
  const size_t smem = attention_smem<CS>();
  cudaError_t e = cudaFuncSetAttribute(attention_kernel<T, CS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attention_kernel<T, CS><<<dim3((S + QB - 1) / QB, C / ch, N), ATT_WARPS * 32, smem, stream>>>(
      qkv, att, S, C, ch, s2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b, const void* wqkv,
                   const void* bqkv, const void* wproj, const void* bproj, void* y, void* qkv,
                   void* att, void* partial, void* stats, int N, int H, int W, int Wp, int C,
                   int ch, float s2, cudaStream_t stream) {
  const int Hp = H + 2, S = H * W, tiles = (S + BM - 1) / BM;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const long n_vec = (long)N * Hp * Wp * (C / 8);
  const long zb = (n_vec + 255) / 256;
  zero_pads_kernel<T><<<(unsigned)(zb < 132 * 8 ? zb : 132 * 8), 256, 0, stream>>>(
      yt, n_vec, H, W, Hp, Wp, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_gemm_kernel<T, false><<<dim3(N * tiles, (3 * C + BN - 1) / BN), THREADS, 0, stream>>>(
      xt, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const T*>(wqkv), static_cast<const float*>(bqkv), nullptr,
      static_cast<T*>(qkv), nullptr, S, W, Hp, Wp, C, 3 * C, tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const T* q = static_cast<const T*>(qkv);
  T* o = static_cast<T*>(att);
  if (ch <= 16)
    e = launch_attention<T, 16>(q, o, N, S, C, ch, s2, stream);
  else if (ch <= 32)
    e = launch_attention<T, 32>(q, o, N, S, C, ch, s2, stream);
  else if (ch <= 64)
    e = launch_attention<T, 64>(q, o, N, S, C, ch, s2, stream);
  else
    e = launch_attention<T, 128>(q, o, N, S, C, ch, s2, stream);
  if (e != cudaSuccess) return e;
  attn_gemm_kernel<T, true><<<dim3(N * tiles, (C + BN - 1) / BN), THREADS, 0, stream>>>(
      static_cast<const T*>(att), nullptr, nullptr, static_cast<const T*>(wproj),
      static_cast<const float*>(bproj), xt, yt, static_cast<float*>(partial), S, W, Hp, Wp, C, C,
      tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (stats == nullptr) return cudaSuccess;
  return reduce_tiles(static_cast<const float*>(partial), static_cast<float*>(stats), N, C, tiles,
                      stream);
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. x, y (N, H+2, Wp, C); a, b (N, C) float32;
// wqkv (C, 3C), wproj (C, C) in x's type; bqkv (3C,), bproj (C,) float32;
// qkv (N * H * W, 3C) and att (N * H * W, C) scratch in x's type; partial
// (N * tiles * 2 * C) float32 and stats (N, 2, C) float32, both null without
// statistics. ch: the head width, any that divides C (C % 8 == 0); any
// token count; 16-byte aligned contiguous buffers.
extern "C" int v2a_spatial_attention_padded(const void* x, const void* a, const void* b,
                                            const void* wqkv, const void* bqkv, const void* wproj,
                                            const void* bproj, void* y, void* qkv, void* att,
                                            void* partial, void* stats, int N, int H, int W,
                                            int Wp, int C, int ch, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Wp < W + 2 || Wp % 8 ||
      ch <= 0 || C % ch || C % 8 ||
      (partial == nullptr) != (stats == nullptr) || a == nullptr || b == nullptr)
    return (int)cudaErrorInvalidValue;
  // the TPU body's logit scale: (ch^-1/4)^2 in double, then float
  const double sc = 1.0 / sqrt(sqrt((double)ch));
  const float s2 = (float)(sc * sc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::launch<__nv_bfloat16>(x, a, b, wqkv, bqkv, wproj, bproj, y, qkv, att,
                                           partial, stats, N, H, W, Wp, C, ch, s2, s);
  if (dtype == 0)
    return (int)v2a::launch<float>(x, a, b, wqkv, bqkv, wproj, bproj, y, qkv, att, partial,
                                   stats, N, H, W, Wp, C, ch, s2, s);
  return (int)cudaErrorInvalidValue;
}
