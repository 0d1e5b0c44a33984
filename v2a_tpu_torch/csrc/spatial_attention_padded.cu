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
//   per head h (legacy layout, q / k / v at 3 ch h + 0 / ch / 2 ch):
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
// 80% of it in the two GEMMs, against 50 MB of stream in and out), and at
// narrow heads the softmax's exp and division per logit on the CUDA cores.
// The bf16 design, three phases on mma.sync m16n8k16 (bf16 in, float32
// sums) on hopper.cuh's primitives, a fill of the pads and the statistics
// pass:
//   1. zero the pad positions of y;
//   2. QKV: a CTA of eight warps owns P interior tokens of one sample (P =
//      64, 32 or 16, from the launch plan `attention_plan` in
//      ops/resblock_kernels.py; two CTAs an SM) x NC columns of 3C (128, or
//      64 where 128 does not divide it). Per 32-channel chunk the
//      tokens' rows (64-byte rows, `row64`) and the chunk's a, b come by
//      cp.async into a 4-stage ring (a step of two chunks multiplied, one
//      activated, two in flight); the affine runs once per element in place
//      and rounds to bf16; the step's two (32 x NC) Wqkv slabs come by TMA
//      through a 3-stage ring on mbarriers. Rows past the sample, channels
//      past C and columns past 3C are zero-filled by the copies. The
//      epilogue adds bqkv in float32, rounds once and writes the (N * S, 3C)
//      scratch with 16-byte stores;
//   3. attention: a CTA owns (a tile of queries, head, sample), a warp 16
//      queries; the tile is 128 queries (eight warps, two CTAs an SM) or,
//      where the grid would leave SMs idle, 64, 32 or 16. The head's ch
//      lanes are cut into slices of CS = 32, 64 or 128 (the next up from
//      ch; 128-wide slices past 128), lanes past ch zero-filled
//      in shared memory, where they add nothing to any dot and their output
//      columns are not stored. Q stays in shared memory, its fragments in
//      registers (reloaded per slice only past 128 lanes); K and V come in
//      bf16 chunks of 64 keys (a slice at a time) through a double-buffered
//      cp.async ring. Pass 1: Q K^T on mma.sync, the logits scaled after
//      the dot, each lane's running row max and float32 row sum over its
//      keys, combined across the four lanes of a row (the max is exact, the
//      sum is taken in another order than the plain version's). Pass 2,
//      per output slice: Q K^T again, p = T(exp(l - max) / sum) with expf
//      and a correctly rounded division (the row's reciprocal and two FMA
//      corrections; an online-softmax rescale of the output would round
//      differently), taken from the accumulators
//      straight into the A fragments of P @ V, which sums in float32; each
//      head output rounded once. Keys past S weigh exactly zero;
//   4. projection: the GEMM of phase 2 over att (N * S, C) x Wproj, its
//      epilogue adding bproj and the residual (interior x) in float32,
//      rounding once into the padded layout and writing the tile's float32
//      column sums of y and y^2 (tiles never straddle two samples);
//   5. `reduce_tiles` adds the tiles in order (deterministic, no atomics).
// The float32 body (tests only) keeps the CUDA-core GEMM tile of
// common.cuh and an attention on CUDA cores with the same rounding points.
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace v2a {
namespace {

using hop::bf16;

constexpr int QB = 64;         // query rows per attention block
constexpr int KC = 64;         // keys per shared-memory chunk
constexpr int ATT_WARPS = 8;   // warps per float32 attention block
constexpr int QPW = QB / ATT_WARPS;  // queries per warp (float32)

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

// -- float32 (tests only): the CUDA-core GEMM tile of common.cuh and
// attention on CUDA cores --

// load_b_tile with the rows past K and the columns past ldw zero-filled.
__device__ __forceinline__ void load_b_tile_masked(float (*Bs)[Lds<float>::B],
                                                   const float* __restrict__ w, int k0, int K,
                                                   int ldw, int n0) {
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
template <bool PROJ>
__global__ void __launch_bounds__(THREADS)
attn_gemm_f32(const float* __restrict__ src, const float* __restrict__ a,
              const float* __restrict__ b, const float* __restrict__ w,
              const float* __restrict__ bias, const float* __restrict__ x,
              float* __restrict__ out, float* __restrict__ partial, int S, int W, int Hp, int Wp,
              int C, int ldw, int tiles) {
  using T = float;
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
    load_b_tile_masked(Bs, w, c0, C, ldw, n0);
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
template <int CS>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_f32(const float* __restrict__ qkv, float* __restrict__ att, int S, int C, int ch,
              float s2) {
  using T = float;
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

template <int CS>
cudaError_t launch_attention_f32(const float* qkv, float* att, int N, int S, int C, int ch,
                                 float s2, cudaStream_t stream) {
  const size_t smem = attention_smem<CS>();
  cudaError_t e = cudaFuncSetAttribute(attention_f32<CS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attention_f32<CS><<<dim3((S + QB - 1) / QB, C / ch, N), ATT_WARPS * 32, smem, stream>>>(
      qkv, att, S, C, ch, s2);
  return cudaGetLastError();
}


// -- bf16: phases 2 and 4, the token-tile GEMM on mma.sync --

constexpr int G_WARPS = 8;    // a GEMM CTA's warps
constexpr int G_ASTAGES = 4;  // token rows: a step multiplied, one activated, two in flight
constexpr int G_BSTAGES = 3;  // weight slabs by TMA
constexpr int G_SUBS = 2;     // 32-channel chunks a step
// one token stage: per chunk P 64-byte rows, then the step's a[64], b[64]
__host__ __device__ constexpr int token_stage_bytes(int P) {
  return G_SUBS * (P * 64 + 2 * 32 * 4);
}
// the slab ring (aligned to its swizzle's period), the token ring and the
// slab ring's mbarriers; the epilogue's float32 P x (NC + 4) tile aliases them
inline size_t gemm_smem(int P, int NC) {
  const size_t ring = (size_t)G_BSTAGES * G_SUBS * hop::SLAB_ROWS * NC * 2 +
                      (size_t)G_ASTAGES * token_stage_bytes(P) + 8 * G_BSTAGES;
  const size_t out = (size_t)P * (NC + 4) * 4;
  return hop::ALIGN_PAD + (ring > out ? ring : out);
}

// PROJ = false (QKV): A = T(x * a + b) of the interior tokens of the padded
// x, out = qkv (N * S, ldw). PROJ = true: A = att (N * S, C), out = y
// (padded) = T(x + A @ w + bias), and the tile's column sums into partial
// (null: none). w (C, ldw) by its tensor map. Grid: N * tiles * slices
// CTAs, the column slices of one token tile adjacent. A pipeline step is
// two 32-channel chunks: two 32-deep products, one CTA barrier.
template <int P, int NC, bool PROJ>
__global__ void __launch_bounds__(G_WARPS * 32, 2)
attn_gemm_bf16(const bf16* __restrict__ src, const float* __restrict__ a,
               const float* __restrict__ b, const float* __restrict__ bias,
               const bf16* __restrict__ x, bf16* __restrict__ out, float* __restrict__ partial,
               int S, int W, int Hp, int Wp, int C, int ldw,
               const __grid_constant__ CUtensorMap wmap) {
  constexpr int NTHR = G_WARPS * 32;
  // warps over rows and cols, their m16 and n8 tiles
  constexpr int WM = P >= 32 ? 2 : 1, WN = G_WARPS / WM;
  constexpr int MT = P / 16 / WM, NT = NC / 8 / WN;
  constexpr int SLAB = hop::slab_bytes<NC>(), AB = token_stage_bytes(P), OLD = NC + 4;
  constexpr int ROWS = P * 64;  // one chunk's token rows
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int slices = (ldw + NC - 1) / NC, tiles = (S + P - 1) / P;
  const int cid = blockIdx.x / slices, n0 = (blockIdx.x % slices) * NC;
  const int n = cid / tiles, tile = cid % tiles, s0 = tile * P;
  const int rows = min(P, S - s0), nsteps = (C + 32 * G_SUBS - 1) / (32 * G_SUBS);
  const uint32_t b_s = hop::smem_u32(smem);
  const uint32_t a_s = b_s + G_BSTAGES * G_SUBS * SLAB;
  const uint32_t bar_s = a_s + G_ASTAGES * AB;
  unsigned char* as = smem + G_BSTAGES * G_SUBS * SLAB;
  uint32_t bph = 0;

  // the padded-stream row of interior token t of sample n
  auto stream_row = [&](int t) { return ((long)n * Hp + 1 + t / W) * Wp + 1 + t % W; };
  // step g's chunks of the tile's rows (zero past the sample and past C)
  // and their a, b into token stage st
  auto issue_a = [&](int g, int st) {
    const uint32_t base = a_s + st * AB;
    for (int v = tid; v < G_SUBS * P * 4; v += NTHR) {
      const int sub = v / (P * 4), r = (v >> 2) % P, ch = v & 3, t = s0 + r;
      const int c = (g * G_SUBS + sub) * 32 + ch * 8;
      const bool in = r < rows && c < C;
      const long row = PROJ ? (long)n * S + t : stream_row(t);
      hop::cp_async16_or_zero(base + sub * ROWS + hop::row64(r, ch),
                              in ? src + row * C + c : src, in);
    }
    if (!PROJ && tid < 32) {
      const int c = g * G_SUBS * 32 + (tid & 15) * 4;
      hop::cp_async16_or_zero(base + G_SUBS * ROWS + tid * 16,
                              (tid < 16 ? a : b) + (long)n * C + (c < C ? c : 0), c < C);
    }
  };
  // the affine in place on token stage st, rounded to bf16; rows past the
  // sample keep their zeros (channels past C have zero a, b and x)
  auto activate = [&](int st) {
    unsigned char* base = as + st * AB;
    const float* ab = reinterpret_cast<const float*>(base + G_SUBS * ROWS);
    for (int v = tid; v < G_SUBS * P * 4; v += NTHR) {
      const int sub = v / (P * 4), r = (v >> 2) % P, ch = v & 3;
      if (r >= rows) continue;
      bf16* p = reinterpret_cast<bf16*>(base + sub * ROWS + hop::row64(r, ch));
      float v8[8];
      load8(p, v8);
      affine8(v8, ab + sub * 32 + ch * 8, ab + G_SUBS * 32 + sub * 32 + ch * 8, false);
      store8(p, v8);
    }
  };
  // step g's (32 x NC) weight slabs (rows past C, columns past ldw zero),
  // by TMA from one thread
  auto issue_b = [&](int g) {
    if (tid == 0)
      hop::tma_slabs<NC>(b_s + (g % G_BSTAGES) * G_SUBS * SLAB, &wmap, g * G_SUBS * 32, 32,
                         G_SUBS, n0, bar_s + 8 * (g % G_BSTAGES));
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  if (tid == 0) {
    for (int i = 0; i < G_BSTAGES; ++i) hop::mbar_init(bar_s + 8 * i, 1);
    hop::fence_mbar_init();
  }
  __syncthreads();
  // one commit group a step: group g holds step g
  for (int g = 0; g < G_ASTAGES - 1; ++g) {
    if (g < nsteps) issue_a(g, g);
    hop::cp_commit();
  }
  for (int g = 0; g < G_BSTAGES - 1 && g < nsteps; ++g) issue_b(g);
  hop::cp_wait<1>();
  __syncthreads();
  if (!PROJ) activate(0);
  for (int j = 0; j < nsteps; ++j) {
    // step j's slabs and activated rows are in place, step j + 1's rows
    // have landed; the stages step j - 1 used may be refilled
    hop::mbar_wait(bar_s + 8 * (j % G_BSTAGES), (bph >> (j % G_BSTAGES)) & 1);
    bph ^= 1u << (j % G_BSTAGES);
    hop::cp_wait<1>();
    hop::fence_proxy_async();
    __syncthreads();
    if (j + G_BSTAGES - 1 < nsteps) issue_b(j + G_BSTAGES - 1);
    if (j + G_ASTAGES - 1 < nsteps) issue_a(j + G_ASTAGES - 1, (j + G_ASTAGES - 1) % G_ASTAGES);
    hop::cp_commit();
    if (!PROJ && j + 1 < nsteps) activate((j + 1) % G_ASTAGES);
    const uint32_t ab = a_s + (j % G_ASTAGES) * AB;
    const uint32_t bb = b_s + (j % G_BSTAGES) * G_SUBS * SLAB;
#pragma unroll
    for (int sub = 0; sub < G_SUBS; ++sub)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          hop::ldsm_x4(ab + sub * ROWS +
                           hop::row64(wm * (P / WM) + mt * 16 + (lane & 15), 2 * kk + (lane >> 4)),
                       af[mt]);
        hop::mma_slab<MT, NT>(acc, bb + sub * SLAB, kk, af, wn * (NC / WN), lane);
      }
  }
  hop::cp_wait<0>();
  __syncthreads();

  // + bias in float32 into a float32 P x NC tile
  float* ot = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wn * (NC / WN) + nt * 8 + (lane & 3) * 2, gc = n0 + col;
    const float b0 = gc < ldw ? bias[gc] : 0.f, b1 = gc + 1 < ldw ? bias[gc + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = wm * (P / WM) + mt * 16 + (lane >> 2) + hh * 8;
        ot[m * OLD + col] = __fadd_rn(acc[mt][nt][2 * hh], b0);
        ot[m * OLD + col + 1] = __fadd_rn(acc[mt][nt][2 * hh + 1], b1);
      }
  }
  __syncthreads();
  // one rounding, 16-byte stores; PROJ: + the residual in float32 first,
  // the unrounded y kept in the tile for the statistics
  for (int v = tid; v < P * (NC / 8); v += NTHR) {
    const int m = v / (NC / 8), ch = v % (NC / 8), gc = n0 + ch * 8;
    if (m >= rows || gc >= ldw) continue;
    float* p = ot + m * OLD + ch * 8;
    float v8[8];
    load8(p, v8);
    if (!PROJ) {
      store8(out + ((long)n * S + s0 + m) * ldw + gc, v8);
      continue;
    }
    const long o = stream_row(s0 + m) * C + gc;
    float x8[8];
    load8(x + o, x8);
#pragma unroll
    for (int i = 0; i < 8; ++i) v8[i] = __fadd_rn(x8[i], v8[i]);
    store8(out + o, v8);
    store8(p, v8);
  }
  if (!PROJ || partial == nullptr) return;
  __syncthreads();
  if (tid < 2 * NC) {
    const int c = tid % NC, which = tid / NC;
    if (n0 + c >= ldw) return;
    float sum = 0.f;
    for (int m = 0; m < rows; ++m) {
      const float v = ot[m * OLD + c];
      sum = __fadd_rn(sum, which ? __fmul_rn(v, v) : v);
    }
    partial[(((long)n * tiles + tile) * 2 + which) * C + n0 + c] = sum;
  }
}

// one GEMM launch: A from src (PROJ: att; else the padded x, activated by
// a, b), w (C, ldw), out (N * S, ldw) or, PROJ, y with the residual x
struct Gemm {
  const bf16* src;
  const float *a, *b;
  const bf16* w;
  const float* bias;
  const bf16* x;
  bf16* out;
  float* partial;
  int N, S, W, Hp, Wp, C, ldw;
};

template <int P, int NC, bool PROJ>
cudaError_t launch_gemm(const Gemm& g, cudaStream_t stream) {
  const size_t smem = gemm_smem(P, NC);
  const long grid = (long)g.N * ((g.S + P - 1) / P) * ((g.ldw + NC - 1) / NC);
  if (smem > 232448 || grid > 0x7fffffffL) return cudaErrorInvalidValue;
  CUtensorMap wmap;
  if (hop::encode_slabs(&wmap, g.w, (uint64_t)g.C, (uint64_t)g.ldw)) return cudaErrorInvalidValue;
  auto kernel = attn_gemm_bf16<P, NC, PROJ>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)grid, G_WARPS * 32, smem, stream>>>(
      g.src, g.a, g.b, g.bias, g.x, g.out, g.partial, g.S, g.W, g.Hp, g.Wp, g.C, g.ldw, wmap);
  return cudaGetLastError();
}

// P tokens a tile (the plan's), NC = 128 columns where 128 divides ldw, else 64
template <bool PROJ>
cudaError_t gemm(int P, const Gemm& g, cudaStream_t s) {
  if (g.ldw % 128 == 0) {
    if (P == 64) return launch_gemm<64, 128, PROJ>(g, s);
    if (P == 32) return launch_gemm<32, 128, PROJ>(g, s);
    if (P == 16) return launch_gemm<16, 128, PROJ>(g, s);
  } else {
    if (P == 64) return launch_gemm<64, 64, PROJ>(g, s);
    if (P == 32) return launch_gemm<32, 64, PROJ>(g, s);
    if (P == 16) return launch_gemm<16, 64, PROJ>(g, s);
  }
  return cudaErrorInvalidValue;
}

// -- bf16: phase 3, attention on mma.sync --

constexpr int AWARPS = 8;  // the most warps a CTA has, 16 queries each

// byte offset of 16-byte chunk c of row r in a tile of CS-lane rows: the
// 64-byte swizzle (`row64`) at 32 lanes, else chunks ^ (row & 7), so the
// eight rows one ldmatrix reads hit eight bank groups
template <int CS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (CS == 32) return hop::row64(r, c);
  else return (uint32_t)(r * CS * 2 + ((c ^ (r & 7)) << 4));
}
// Q's slices (Q rows), two K and two V tiles of 64 rows, x CS lanes
inline size_t attention_bf16_smem(int CS, int slices, int Q) {
  return (size_t)(slices * Q + 4 * KC) * CS * 2;
}

// Block (query tile, head, sample); qkv (N * S, 3C) -> att (N * S, C). A
// warp a 16-query slice of the tile: blockDim.x / 2 queries (128, 64, 32 or
// 16, from the plan: the most that still give a CTA per SM).
template <int CS>
__global__ void __launch_bounds__(AWARPS * 32, CS == 128 ? 1 : 2)
attention_bf16(const bf16* __restrict__ qkv, bf16* __restrict__ att, int S, int C, int ch,
               float s2) {
  constexpr int KQ = CS / 16, NO = CS / 8;  // k16 steps of a slice, n8 tiles of an output slice
  constexpr int TB = KC * CS * 2;  // a K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  const int nthr = blockDim.x, qb = nthr / 2, QT = qb * CS * 2;  // queries, a Q slice's bytes
  const int nsl = (ch + CS - 1) / CS, nj = (S + KC - 1) / KC, nu = nj * nsl;
  const uint32_t q_s = hop::smem_u32(smem), k_s = q_s + nsl * QT, v_s = k_s + 2 * TB;
  const int q0 = blockIdx.x * qb, hd = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long ld = 3L * C;
  const bf16* base = qkv + (long)n * S * ld + (long)hd * 3 * ch;
  const bool vec = ch % 8 == 0;

  // lanes [CS sl, CS sl + CS) of rows r0 .. r0 + rows - 1 of q (at 0), k (at
  // ch) or v (at 2 ch) into the tile at dst; rows past S and lanes past ch zero
  auto load = [&](uint32_t dst, int r0, int rows, int at, int sl) {
    for (int v = tid; v < rows * NO; v += nthr) {
      const int r = v / NO, u = v % NO, row = r0 + r, d0 = sl * CS + u * 8;
      const bf16* g = base + (long)row * ld + at + d0;
      const bool in = row < S && d0 < ch;
      if (vec || !in) {
        hop::cp_async16_or_zero(dst + swz<CS>(r, u), in ? g : qkv, in);
      } else {  // a head width no multiple of 8: element by element
        uint4 pk;
        bf16* e = reinterpret_cast<bf16*>(&pk);
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = d0 + i < ch ? g[i] : __float2bfloat16_rn(0.f);
        *reinterpret_cast<uint4*>(smem + (dst - q_s) + swz<CS>(r, u)) = pk;
      }
    }
  };
  // unit u = (key chunk u / nsl, slice u % nsl): its K slice, and with
  // with_v the chunk's V slice osl beside its first K slice
  auto issue = [&](int u, bool with_v, int osl) {
    const int j = u / nsl, sl = u % nsl;
    load(k_s + (u & 1) * TB, j * KC, KC, ch, sl);
    if (with_v && sl == 0) load(v_s + (j & 1) * TB, j * KC, KC, 2 * ch, osl);
  };

  uint32_t qf[KQ][4];  // this warp's Q fragments of one slice
  bool have_q = false;
  float lg[8][4];      // this warp's 16 x 64 logits of a key chunk
  // one sweep over the units; after a chunk's last slice, its logits
  // scaled and the keys past S at -inf, `chunk(j)`
  auto sweep = [&](bool with_v, int osl, auto&& chunk) {
    __syncthreads();  // every read of the previous sweep's tiles is done
    issue(0, with_v, osl);
    hop::cp_commit();
    for (int u = 0; u < nu; ++u) {
      hop::cp_wait<0>();
      __syncthreads();
      if (u + 1 < nu) issue(u + 1, with_v, osl);
      hop::cp_commit();
      const int j = u / nsl, sl = u % nsl;
      if (nsl > 1 || !have_q) {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk)
          hop::ldsm_x4(q_s + sl * QT + swz<CS>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)),
                       qf[kk]);
        have_q = true;
      }
      if (sl == 0) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) lg[t][e] = 0.f;
      }
      const uint32_t kb = k_s + (u & 1) * TB;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bq[4];
          hop::ldsm_x4(kb + swz<CS>(np * 16 + (lane >> 4) * 8 + (lane & 7),
                                    2 * kk + ((lane >> 3) & 1)),
                       bq);
          hop::mma16816(lg[2 * np], qf[kk], bq[0], bq[1]);
          hop::mma16816(lg[2 * np + 1], qf[kk], bq[2], bq[3]);
        }
      if (sl == nsl - 1) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) lg[t][e] = __fmul_rn(lg[t][e], s2);
        if ((j + 1) * KC > S) {  // the last chunk, past S
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j * KC + t * 8 + (lane & 3) * 2 + (e & 1) >= S) lg[t][e] = -INFINITY;
        }
        chunk(j);
      }
    }
  };

  // Q, every slice, lands with the first unit
  for (int sl = 0; sl < nsl; ++sl) load(q_s + sl * QT, q0, qb, 0, sl);

  // pass 1: per lane and row (i: rows lane / 4 and + 8), the running max
  // and sum of exp over the lane's keys
  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
  sweep(false, 0, [&](int) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float nm = mx[i];
#pragma unroll
      for (int t = 0; t < 8; ++t) nm = fmaxf(nm, fmaxf(lg[t][2 * i], lg[t][2 * i + 1]));
      if (nm == -INFINITY) continue;  // every key of the lane so far past S
      float s = __fmul_rn(sm[i], expf(__fsub_rn(mx[i], nm)));
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) s = __fadd_rn(s, expf(__fsub_rn(lg[t][2 * i + e], nm)));
      sm[i] = s;
      mx[i] = nm;
    }
  });
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mx[i], o);
      const float s2v = __shfl_xor_sync(0xffffffffu, sm[i], o);
      const float m = fmaxf(mx[i], m2);
      const float x1 = mx[i] == -INFINITY ? 0.f : __fmul_rn(sm[i], expf(__fsub_rn(mx[i], m)));
      const float x2 = m2 == -INFINITY ? 0.f : __fmul_rn(s2v, expf(__fsub_rn(m2, m)));
      sm[i] = __fadd_rn(x1, x2);
      mx[i] = m;
    }

  // p = RN(ex / sum), the value of __fdiv_rn(ex, sum) without a reciprocal
  // per element (the special-function unit, one per logit for the exp, is
  // what bounds this loop): the sum's correctly rounded reciprocal once per
  // row, then per element a product and two FMA corrections (Markstein: the
  // first makes the quotient faithful, the second rounds it correctly;
  // subnormal quotients aside)
  const float rs[2] = {__frcp_rn(sm[0]), __frcp_rn(sm[1])};
  auto divide = [&](float ex, int i) {
    float q = __fmul_rn(ex, rs[i]);
    q = __fmaf_rn(__fmaf_rn(-q, sm[i], ex), rs[i], q);
    return __fmaf_rn(__fmaf_rn(-q, sm[i], ex), rs[i], q);
  };

  // pass 2, per output slice: p = T(ex / sum) into P @ V's A fragments
  for (int osl = 0; osl < nsl; ++osl) {
    float o[NO][4];
#pragma unroll
    for (int t = 0; t < NO; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
    sweep(true, osl, [&](int j) {
      const uint32_t vb = v_s + (j & 1) * TB;
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        uint32_t pa[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float p0 = divide(expf(__fsub_rn(lg[2 * kt + h][2 * i], mx[i])), i);
            const float p1 = divide(expf(__fsub_rn(lg[2 * kt + h][2 * i + 1], mx[i])), i);
            const __nv_bfloat162 pp = __floats2bfloat162_rn(p0, p1);
            pa[2 * h + i] = *reinterpret_cast<const uint32_t*>(&pp);
          }
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t vq[4];
          hop::ldsm_x4_t(vb + swz<CS>(kt * 16 + (lane & 15), 2 * np + (lane >> 4)), vq);
          hop::mma16816(o[2 * np], pa, vq[0], vq[1]);
          hop::mma16816(o[2 * np + 1], pa, vq[2], vq[3]);
        }
      }
    });
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = q0 + warp * 16 + (lane >> 2) + 8 * i;
      if (qr >= S) continue;
      bf16* dst = att + ((long)n * S + qr) * C + (long)hd * ch + osl * CS;
#pragma unroll
      for (int t = 0; t < NO; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = t * 8 + (lane & 3) * 2 + e;
          if (osl * CS + d < ch) dst[d] = __float2bfloat16_rn(o[t][2 * i + e]);
        }
    }
  }
}

template <int CS>
cudaError_t launch_attention_bf16(const bf16* qkv, bf16* att, int N, int S, int C, int ch,
                                  float s2, int Q, cudaStream_t stream) {
  const size_t smem = attention_bf16_smem(CS, (ch + CS - 1) / CS, Q);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_bf16<CS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (Q != 128 && Q != 64 && Q != 32 && Q != 16) return cudaErrorInvalidValue;
  attention_bf16<CS><<<dim3((S + Q - 1) / Q, C / ch, N), Q * 2, smem, stream>>>(
      qkv, att, S, C, ch, s2);
  return cudaGetLastError();
}

// CS: the next of 32, 64, 128 up from ch; 128-wide slices past 128. Q:
// queries a CTA
cudaError_t attention(const bf16* qkv, bf16* att, int N, int S, int C, int ch, float s2, int Q,
                      cudaStream_t stream) {
  if (ch <= 32) return launch_attention_bf16<32>(qkv, att, N, S, C, ch, s2, Q, stream);
  if (ch <= 64) return launch_attention_bf16<64>(qkv, att, N, S, C, ch, s2, Q, stream);
  return launch_attention_bf16<128>(qkv, att, N, S, C, ch, s2, Q, stream);
}

template <typename T>
cudaError_t zero_pads(T* y, int N, int H, int W, int Wp, int C, cudaStream_t stream) {
  const long n_vec = (long)N * (H + 2) * Wp * (C / 8);
  const long zb = (n_vec + 255) / 256;
  zero_pads_kernel<T><<<(unsigned)(zb < 132 * 8 ? zb : 132 * 8), 256, 0, stream>>>(
      y, n_vec, H, W, H + 2, Wp, C);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const bf16* x, const float* a, const float* b, const bf16* wqkv,
                        const float* bqkv, const bf16* wproj, const float* bproj, bf16* y,
                        bf16* qkv, bf16* att, float* partial, float* stats, int N, int H, int W,
                        int Wp, int C, int ch, float s2, int Pq, int Qa, int Pp,
                        cudaStream_t s) {
  const int Hp = H + 2, S = H * W;
  const Gemm qkv_in = {x, a, b, wqkv, bqkv, nullptr, qkv, nullptr, N, S, W, Hp, Wp, C, 3 * C};
  const Gemm proj_in = {att, nullptr, nullptr, wproj, bproj, x, y, partial, N, S, W, Hp, Wp, C, C};
  cudaError_t e = zero_pads(y, N, H, W, Wp, C, s);
  if (e != cudaSuccess) return e;
  e = gemm<false>(Pq, qkv_in, s);
  if (e != cudaSuccess) return e;
  e = attention(qkv, att, N, S, C, ch, s2, Qa, s);
  if (e != cudaSuccess) return e;
  e = gemm<true>(Pp, proj_in, s);
  if (e != cudaSuccess) return e;
  if (stats == nullptr) return cudaSuccess;
  return reduce_tiles(partial, stats, N, C, (S + Pp - 1) / Pp, s);
}

cudaError_t launch_f32(const float* x, const float* a, const float* b, const float* wqkv,
                       const float* bqkv, const float* wproj, const float* bproj, float* y,
                       float* qkv, float* att, float* partial, float* stats, int N, int H, int W,
                       int Wp, int C, int ch, float s2, cudaStream_t stream) {
  const int Hp = H + 2, S = H * W, tiles = (S + BM - 1) / BM;
  cudaError_t e = zero_pads(y, N, H, W, Wp, C, stream);
  if (e != cudaSuccess) return e;
  attn_gemm_f32<false><<<dim3(N * tiles, (3 * C + BN - 1) / BN), THREADS, 0, stream>>>(
      x, a, b, wqkv, bqkv, nullptr, qkv, nullptr, S, W, Hp, Wp, C, 3 * C, tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (ch <= 16)
    e = launch_attention_f32<16>(qkv, att, N, S, C, ch, s2, stream);
  else if (ch <= 32)
    e = launch_attention_f32<32>(qkv, att, N, S, C, ch, s2, stream);
  else if (ch <= 64)
    e = launch_attention_f32<64>(qkv, att, N, S, C, ch, s2, stream);
  else
    e = launch_attention_f32<128>(qkv, att, N, S, C, ch, s2, stream);
  if (e != cudaSuccess) return e;
  attn_gemm_f32<true><<<dim3(N * tiles, (C + BN - 1) / BN), THREADS, 0, stream>>>(
      att, nullptr, nullptr, wproj, bproj, x, y, partial, S, W, Hp, Wp, C, C, tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (stats == nullptr) return cudaSuccess;
  return reduce_tiles(partial, stats, N, C, tiles, stream);
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. x, y (N, H+2, Wp, C); a, b (N, C) float32;
// wqkv (C, 3C), wproj (C, C) in x's type; bqkv (3C,), bproj (C,) float32;
// qkv (N * H * W, 3C) and att (N * H * W, C) scratch in x's type; partial
// (N * tiles * 2 * C) float32 and stats (N, 2, C) float32, both null without
// statistics, tiles = ceil(H * W / Pp) (float32: / 64). ch: the head width,
// any that divides C (C % 8 == 0) whose attention tiles fit shared memory
// (`attention_plan`); any token count. Pq, Pp: the tokens a tile of the
// bf16 QKV and projection GEMMs (64, 32 or 16), Qa the queries an
// attention CTA (128, 64, 32 or 16), all from
// `attention_plan`. 16-byte aligned contiguous buffers.
extern "C" int v2a_spatial_attention_padded(const void* x, const void* a, const void* b,
                                            const void* wqkv, const void* bqkv, const void* wproj,
                                            const void* bproj, void* y, void* qkv, void* att,
                                            void* partial, void* stats, int N, int H, int W,
                                            int Wp, int C, int ch, int Pq, int Qa, int Pp,
                                            int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Wp < W + 2 || Wp % 8 ||
      ch <= 0 || C % ch || C % 8 ||
      (partial == nullptr) != (stats == nullptr) || a == nullptr || b == nullptr)
    return (int)cudaErrorInvalidValue;
  // the TPU body's logit scale: (ch^-1/4)^2 in double, then float
  const double sc = 1.0 / sqrt(sqrt((double)ch));
  const float s2 = (float)(sc * sc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using v2a::bf16;
  if (dtype == 1)
    return (int)v2a::launch_bf16(
        static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
        static_cast<const bf16*>(wproj), static_cast<const float*>(bproj), static_cast<bf16*>(y),
        static_cast<bf16*>(qkv), static_cast<bf16*>(att), static_cast<float*>(partial),
        static_cast<float*>(stats), N, H, W, Wp, C, ch, s2, Pq, Qa, Pp, s);
  if (dtype == 0)
    return (int)v2a::launch_f32(
        static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(wqkv), static_cast<const float*>(bqkv),
        static_cast<const float*>(wproj), static_cast<const float*>(bproj),
        static_cast<float*>(y), static_cast<float*>(qkv), static_cast<float*>(att),
        static_cast<float*>(partial), static_cast<float*>(stats), N, H, W, Wp, C, ch, s2, s);
  return (int)cudaErrorInvalidValue;
}
