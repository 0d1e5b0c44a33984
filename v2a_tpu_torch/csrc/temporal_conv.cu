// K2: y = temporal_conv3(x) + bias [+ emb] [+ residual] on (B, F, S, C), and
// K4b: the same on the interior of a padded stream (B, F, H+2, Wp, C) with
// the ResBlock's 1x1 skip projection folded in; both optionally with the
// per-(B, F, C) sum / sum of squares of the rounded y. K11 is K2's entry.
//
// Replaces the TPU kernels `temporal_conv_fused`
// (v2a_tpu/ops/resblock_kernels.py:177, body `_tconv_kernel` :95),
// `temporal_conv_padded` (:1090, body `_tconv_padded_kernel` :983) and
// `temporal_conv_fused_hw` (:340, body `_tconv_hw_kernel` :266).
//
// y[b, f, s] = sum_t x[b, f + t - 1, s] @ W[t] with frames zero-padded on
// BOTH sides (the conv is not causal) [K4b: + sum_i x_i[b, f, s] @ K_i in
// the same float32 sum], then + (bias + emb[b]) [+ skip bias] [+ residual]
// in float32, rounded once to the input type. The statistics are taken
// from the rounded values (K4b: of the interior), as the TPU kernels take
// them. K4b writes y's pad cols as zeros; pad rows are neither read nor
// written, so they may hold anything (NaN included).
//
// What bounds it on the H100: operations from C = 256 on, bytes below
// (56 x 128^2 x 128: 8.2e10 FLOP, 0.08 ms, against 0.35 GB of x, residual
// and y, 0.11 ms; 56 x 16^2 x 512: 3.3e10 FLOP against 0.04 GB). What a
// tiled kernel spends beyond that is traffic from L2 into the SMs: each
// CTA reads its tiles' neighbour frames and the whole (3 C x NC) weight
// slice of its output channels. One bf16 body serves both entries, on
// hopper.cuh's primitives:
//
// - An implicit GEMM: a CTA owns P interior pixels (a flat range of the
//   slab's H * W interior) of T = 2 consecutive frames (or 1) of one sample
//   x NC output channels (128, or 64 where 128 does not divide C); K = 3 C,
//   then the skip parts' C_i. Two frames share the loaded frames f0 .. f0 +
//   1 and every weight slab, so a frame pair reads 4 A tiles and one weight
//   slice where two single frames read 6 and two. The launch plan
//   (`plan_of`; `temporal_conv_plan` in ops/resblock_kernels.py computes
//   the same) picks (P, T) with P in {128 (sixteen warps), 64, 32, 16
//   (eight)}: the most work a CTA whose grid still has a CTA per SM, so a
//   B = 1 request fills the card too. The C / NC slices of one tile are
//   adjacent in the grid, so the tile's rows come from device memory once
//   and from L2 after.
// - A pipeline step is the three taps of one 32-channel chunk: 32-deep
//   products on mma.sync m16n8k16 (bf16 in, float32 sums), each A tile
//   read once by ldmatrix into every output frame that takes it. The
//   step's T + 2 A tiles (frames f0 - 1 .. f0 + T: P rows of 64 bytes,
//   `row64`) come by cp.async into a 3-stage ring, positions past the
//   interior zero-filled by the copy and never loaded; its three (32 x NC)
//   weight slabs come by TMA (one thread, 2-D boxes, 128-byte swizzle) into
//   the same stage, completing on its mbarrier: K1's weight ring
//   (affine_conv3x3.cu), one CTA barrier a step. A missing temporal
//   neighbour (frames -1 and F) is neither copied nor multiplied.
// - K4b's skip parts are further steps of the same accumulators: up to
//   three (T = 1) or two (T = 2) 32-channel chunks of x_i at each output
//   frame against their rows of K_i, each part with its own tensor map.
// - The epilogue holds bias, emb and skip bias in registers, loads the
//   residual as pairs before the first store, rounds once, takes the tile's
//   column sums of the rounded y (rows per thread, a shuffle tree, then the
//   row warps in order), stages each frame's tile in shared memory (rows'
//   chunks ^ (row & 7)) and writes it with 16-byte stores; K4b's pixels at
//   w = 0 and w = W - 1 also write the zero pad cols. Blocks run in no
//   order, so each writes its tiles' sums and a second pass
//   (`reduce_tiles`) adds them in tile order: deterministic, no atomics.
//
// Every output element is the same sequence of mma.sync steps (chunks in
// order, taps 0, 1, 2 within a chunk, then the skip chunks) whatever P, T
// and NC, so the plan moves no bit of y, only the statistics' tiles. K4b
// differs from K2 only in the addressing (pixel s of the interior at
// padded (s / W + 1, s % W + 1); K2's entry is the same body with H = 1,
// W = S, no padding), the skip parts and the pad-col writes. With no skip
// part and the same plan, K4b on a padded copy of K2's input runs K2's
// products in K2's order: the same y and statistics bit for bit.
//
// K11 computes K2's function on the (S, B, F, C) view of the same tensor.
// On the TPU that view was a layout bitcast; here it is only another
// address map over the caller's (B, F, S, C) memory, so its wrapper
// (`temporal_conv_fused_hw` in ops/resblock_kernels.py) launches
// `v2a_temporal_conv3` on x itself: no copy of x, the residual or y, and
// K2's y and statistics bit for bit.
//
// The float32 body (tests only) is the plain CUDA-core implicit GEMM of
// common.cuh (`Accum<float>`): 64-pixel x 64-channel tiles, per (tap,
// 32-channel) step.
#include "common.cuh"
#include "hopper.cuh"

namespace v2a {
namespace {

using hop::bf16;

// warps a CTA: sixteen at 128-pixel tiles, else eight
__host__ __device__ constexpr int warps_of(int P) { return P == 128 ? 16 : 8; }
constexpr int TC_STAGES = 3;  // the ring: a step's A tiles and weight slabs a stage
constexpr int SMS = 132;      // the H100 SXM's streaming multiprocessors
// A tiles a stage: a tap step's T + 2 frames f0 - 1 .. f0 + T
__host__ __device__ constexpr int a_tiles(int T) { return T + 2; }
// 32-channel chunks a skip step: as many as the A tiles hold for T frames
__host__ __device__ constexpr int skip_chunks(int T) { return T == 1 ? 3 : 2; }

// The ring (three weight slabs a stage first, aligned to their swizzle's
// period; then T + 2 A tiles a stage, P rows of 64 bytes each; then one
// mbarrier a stage); the epilogue's T (P x NC) tiles and the statistics'
// T x (row warps x 2) x NC floats alias it
inline size_t smem_bytes(int P, int NC, int T) {
  const size_t ring =
      (size_t)TC_STAGES * (3 * hop::SLAB_ROWS * NC * 2 + a_tiles(T) * P * 64) + 8 * TC_STAGES;
  const size_t out = (size_t)T * (P * NC * 2 + 4 * 2 * NC * 4);
  return hop::ALIGN_PAD + (ring > out ? ring : out);
}

struct Plan {
  int P, T, NC, tiles;  // pixels per tile, frames per CTA, output channels per CTA, tiles per slab
  long grid;
  size_t smem;
};

// (P, T) from the most work a CTA to the least: by P * T, frame pairs first
// at a tie, a larger P only where it needs fewer tiles than half of it; the
// first whose grid has a CTA per SM, else (16, 1) (the most CTAs). Every
// one fits the shared memory.
inline Plan plan_of(int B, int F, int S, int C) {
  const int NC = C % 128 ? 64 : 128;
  const int order[8][2] = {{128, 2}, {64, 2}, {128, 1}, {32, 2},
                           {64, 1},  {16, 2}, {32, 1},  {16, 1}};
  Plan p = {};
  for (const auto& pt : order) {
    const int P = pt[0], T = pt[1], tiles = (S + P - 1) / P;
    if (P > 16 && tiles >= (S + P / 2 - 1) / (P / 2)) continue;
    p = Plan{P, T, NC, tiles, (long)B * ((F + T - 1) / T) * tiles * (C / NC),
             smem_bytes(P, NC, T)};
    if (p.grid >= SMS) break;
  }
  return p;
}

// Both entries' operands. Wp = 0: K2's (B, F, S, C) layout, with H = 1,
// W = S; Wp > 0: K4b's padded stream (B, F, H+2, Wp, C). w: (3 C, C)
// tap-major; skip part i: x_i like x with C_i channels, k_i (C_i, C).
template <typename T>
struct Args {
  const T* x;
  const T* w;
  const float* bias;
  const float* emb;
  const T* res;
  Skip<T> q[2];
  const float* sbias;
  T* y;
  float* partial;
  int F, H, W, Wp, C, tiles;
};

// row of interior pixel s within its (b, f) slab
__device__ __forceinline__ long pos_of(int s, int W, int Wp) {
  return Wp ? (long)(s / W + 1) * Wp + s % W + 1 : s;
}

// the (3 C, C) weights and each skip part's (C_i, C) in slab boxes
// (`hop::encode_slabs`)
struct Maps {
  CUtensorMap w, k[2];
};

// A CTA: P pixels of T consecutive frames f0 .. f0 + T - 1 (fewer at the
// last frames) of one sample x NC output channels. Grid: B * ceil(F / T) *
// tiles * (C / NC) CTAs, the C slices of one tile adjacent.
template <int P, int NC, int T>
__global__ void __launch_bounds__(warps_of(P) * 32, P == 128 ? 1 : 2)
temporal_conv_bf16(const Args<bf16> a, const __grid_constant__ Maps maps) {
  constexpr int NTHR = warps_of(P) * 32;
  // warps over rows and over cols
  constexpr int WM = P == 128 ? 4 : P >= 32 ? 2 : 1, WN = warps_of(P) / WM;
  constexpr int MT = P / 16 / WM, NT = NC / 8 / WN;  // m16 and n8 tiles a warp
  constexpr int NA = a_tiles(T), SK = skip_chunks(T);
  constexpr int SLAB = hop::slab_bytes<NC>(), TILE = P * 64, RB = NC * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int C = a.C, slices = C / NC, groups = (a.F + T - 1) / T;
  const int cid = blockIdx.x / slices, n0 = (blockIdx.x % slices) * NC;
  const int grp = cid / a.tiles, tile = cid % a.tiles;
  const int b = grp / groups, f0 = (grp % groups) * T;
  const int nout = a.F - f0 < T ? a.F - f0 : T;  // output frames of this CTA
  const int S = a.H * a.W, s0 = tile * P;
  const long frame = a.Wp ? (long)(a.H + 2) * a.Wp : S;  // rows of one (b, f) slab
  const long fbase = (long)b * a.F + f0;                 // slab of output frame 0
  // A tile li of a tap step holds frame f0 - 1 + li; `need`: those some
  // output frame takes (a missing neighbour is neither copied nor multiplied)
  uint32_t need = 0;
#pragma unroll
  for (int li = 0; li < NA; ++li)
    if (f0 - 1 + li >= 0 && f0 - 1 + li < a.F && li <= nout + 1) need |= 1u << li;
  const int nch = C / 32;
  const int sk0 = a.q[0].C / 32, sk1 = a.q[1].C / 32;
  const int ss0 = (sk0 + SK - 1) / SK, ss1 = (sk1 + SK - 1) / SK;
  const int nsteps = nch + ss0 + ss1;
  const uint32_t b_s = hop::smem_u32(smem);
  const uint32_t a_s = b_s + TC_STAGES * 3 * SLAB;
  const uint32_t bar_s = a_s + TC_STAGES * NA * TILE;
  uint32_t bph = 0;  // each stage's mbarrier's next phase

  // the 16 bytes this thread copies of each A tile: row cr, chunk cc
  const int cr = tid >> 2, cc = tid & 3;
  const bool copier = cr < P;
  const bool in = copier && s0 + cr < S;  // else zero-filled
  const long crow = in ? pos_of(s0 + cr, a.W, a.Wp) : 0;

  // skip step i: its part, first chunk and chunks
  auto skip_of = [&](int i, int& part, int& c, int& ns) {
    part = i < ss0 ? 0 : 1;
    const int k = part ? i - ss0 : i, n = part ? sk1 : sk0;
    c = k * SK;
    ns = n - c < SK ? n - c : SK;
  };
  // step j's weight slabs, by TMA from one thread: taps 0..2 of chunk j
  // (rows t * C + 32 j), or a skip step's chunks of its part's K_i
  auto issue_b = [&](int j) {
    if (tid) return;
    const uint32_t dst = b_s + (j % TC_STAGES) * 3 * SLAB, bar = bar_s + 8 * (j % TC_STAGES);
    if (j < nch) {
      hop::tma_slabs<NC>(dst, &maps.w, j * 32, C, 3, n0, bar);
    } else {
      int part, c, ns;
      skip_of(j - nch, part, c, ns);
      hop::tma_slabs<NC>(dst, &maps.k[part], c * 32, 32, ns, n0, bar);
    }
  };
  // step j's A tiles by cp.async: chunk j of frames f0 - 1 .. f0 + T, or a
  // skip step's chunks u of x_i at each output frame e (tile u * T + e)
  auto issue_a = [&](int j) {
    if (!copier) return;
    const uint32_t dst = a_s + (j % TC_STAGES) * NA * TILE + hop::row64(cr, cc);
    if (j < nch) {
#pragma unroll
      for (int li = 0; li < NA; ++li) {
        if (!((need >> li) & 1)) continue;
        const bf16* src = a.x + ((fbase - 1 + li) * frame + crow) * C + j * 32 + cc * 8;
        hop::cp_async16_or_zero(dst + li * TILE, in ? src : a.x, in);
      }
    } else {
      int part, c, ns;
      skip_of(j - nch, part, c, ns);
      const Skip<bf16> q = part ? a.q[1] : a.q[0];
      for (int u = 0; u < ns; ++u)
        for (int e = 0; e < nout; ++e) {
          const bf16* src = q.x + ((fbase + e) * frame + crow) * q.C + (c + u) * 32 + cc * 8;
          hop::cp_async16_or_zero(dst + (u * T + e) * TILE, in ? src : q.x, in);
        }
    }
  };

  // this lane's ldmatrix row of each m16 tile
  int arow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) arow[mt] = wm * (P / WM) + mt * 16 + (lane & 15);
  float acc[T][MT][NT][4];
#pragma unroll
  for (int e = 0; e < T; ++e)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[e][mt][nt][i] = 0.f;

  if (tid == 0) {
    for (int i = 0; i < TC_STAGES; ++i) hop::mbar_init(bar_s + 8 * i, 1);
    hop::fence_mbar_init();
  }
  __syncthreads();
  for (int j = 0; j < TC_STAGES - 1; ++j) {
    if (j < nsteps) {
      issue_b(j);
      issue_a(j);
    }
    hop::cp_commit();
  }
  for (int j = 0; j < nsteps; ++j) {
    const int st = j % TC_STAGES;
    // step j's slabs and A tiles are in place; the stage step j - 1 read
    // may be refilled (each thread's reads ordered before the TMA writes)
    hop::mbar_wait(bar_s + 8 * st, (bph >> st) & 1);
    bph ^= 1u << st;
    hop::cp_wait<TC_STAGES - 2>();
    hop::fence_proxy_async();
    __syncthreads();
    if (j + TC_STAGES - 1 < nsteps) {
      issue_b(j + TC_STAGES - 1);
      issue_a(j + TC_STAGES - 1);
    }
    hop::cp_commit();
    const uint32_t ab = a_s + st * NA * TILE, bb = b_s + st * 3 * SLAB;
    if (j < nch) {
      // each A tile once, into every output frame that takes it: frame e
      // takes tile e + t with tap t, so its taps come in order 0, 1, 2
#pragma unroll
      for (int li = 0; li < NA; ++li) {
        if (!((need >> li) & 1)) continue;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t af[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            hop::ldsm_x4(ab + li * TILE + hop::row64(arow[mt], 2 * kk + (lane >> 4)), af[mt]);
#pragma unroll
          for (int e = 0; e < T; ++e) {
            const int t = li - e;
            if (t < 0 || t > 2 || e >= nout) continue;
            hop::mma_slab<MT, NT>(acc[e], bb + t * SLAB, kk, af, wn * (NC / WN), lane);
          }
        }
      }
    } else {
      int part, c, ns;
      skip_of(j - nch, part, c, ns);
#pragma unroll
      for (int u = 0; u < SK; ++u)
#pragma unroll
        for (int e = 0; e < T; ++e) {
          if (u >= ns || e >= nout) continue;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t af[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              hop::ldsm_x4(ab + (u * T + e) * TILE + hop::row64(arow[mt], 2 * kk + (lane >> 4)),
                           af[mt]);
            hop::mma_slab<MT, NT>(acc[e], bb + u * SLAB, kk, af, wn * (NC / WN), lane);
          }
        }
    }
  }
  hop::cp_wait<0>();
  __syncthreads();

  // the epilogue of each output frame e: this thread's rows (-1 past the
  // interior) and the residual's pairs, all loaded before the first store
  const int cw = wn * (NC / WN) + (lane & 3) * 2;  // first column of this thread
  float off[NT][2], sbv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + cw + nt * 8 + j;
      off[nt][j] = a.bias[n];
      if (a.emb) off[nt][j] += a.emb[(long)b * C + n];
      sbv[nt][j] = a.sbias ? a.sbias[n] : 0.f;
    }
  float* red = reinterpret_cast<float*>(smem + T * P * RB);  // (T x WM x 2) rows of NC
#pragma unroll
  for (int e = 0; e < T; ++e) {
    if (e >= nout) continue;
    unsigned char* out = smem + e * P * RB;
    long orow[MT][2];
    float2 rv[MT][2][NT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = s0 + wm * (P / WM) + mt * 16 + (lane >> 2) + hh * 8;
        orow[mt][hh] = s < S ? (fbase + e) * frame + pos_of(s, a.W, a.Wp) : -1;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          rv[mt][hh][nt] = a.res && orow[mt][hh] >= 0
                               ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                     a.res + orow[mt][hh] * C + n0 + cw + nt * 8))
                               : make_float2(0.f, 0.f);
      }
    // + bias in float32, one rounding, staged as P rows of NC (chunks ^
    // (row & 7)); the column sums of the rounded interior rows
    float sum[NT][2][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) sum[nt][j][0] = sum[nt][j][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = wm * (P / WM) + mt * 16 + (lane >> 2) + hh * 8;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            v[j] = acc[e][mt][nt][2 * hh + j] + off[nt][j];
            if (a.sbias) v[j] += sbv[nt][j];
          }
          if (a.res) {
            v[0] += rv[mt][hh][nt].x;
            v[1] += rv[mt][hh][nt].y;
          }
          const __nv_bfloat162 r = __floats2bfloat162_rn(v[0], v[1]);
          const int col = cw + nt * 8;
          *reinterpret_cast<__nv_bfloat162*>(out + m * RB + (((col >> 3) ^ (m & 7)) << 4) +
                                             (col & 7) * 2) = r;
          if (orow[mt][hh] >= 0) {
            const float2 q = __bfloat1622float2(r);
            sum[nt][0][0] += q.x;
            sum[nt][0][1] += q.x * q.x;
            sum[nt][1][0] += q.y;
            sum[nt][1][1] += q.y * q.y;
          }
        }
      }
    if (a.partial) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int which = 0; which < 2; ++which)
#pragma unroll
            for (int o = 4; o < 32; o <<= 1)
              sum[nt][j][which] += __shfl_xor_sync(0xffffffffu, sum[nt][j][which], o);
      if (lane < 4) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = cw + nt * 8 + j;
            red[((e * WM + wm) * 2) * NC + col] = sum[nt][j][0];
            red[((e * WM + wm) * 2 + 1) * NC + col] = sum[nt][j][1];
          }
      }
    }
  }
  __syncthreads();
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int v = tid; v < nout * P * (NC / 8); v += NTHR) {
    const int e = v / (P * (NC / 8)), m = v / (NC / 8) % P, ch = v % (NC / 8), s = s0 + m;
    if (s >= S) continue;
    bf16* o = a.y + ((fbase + e) * frame + pos_of(s, a.W, a.Wp)) * C + n0 + ch * 8;
    *reinterpret_cast<uint4*>(o) =
        *reinterpret_cast<const uint4*>(smem + (e * P + m) * RB + ((ch ^ (m & 7)) << 4));
    if (a.Wp && s % a.W == 0) *reinterpret_cast<uint4*>(o - C) = zero;
    if (a.Wp && s % a.W == a.W - 1)
      for (int k = 1; k < a.Wp - a.W; ++k) *reinterpret_cast<uint4*>(o + (long)k * C) = zero;
  }
  if (!a.partial) return;
  for (int i = tid; i < nout * 2 * NC; i += NTHR) {
    const int e = i / (2 * NC), which = i / NC % 2, col = i % NC;
    float v = 0.f;
    for (int r = 0; r < WM; ++r) v += red[((e * WM + r) * 2 + which) * NC + col];
    a.partial[(((fbase + e) * a.tiles + tile) * 2 + which) * C + n0 + col] = v;
  }
}

template <int P, int NC, int T>
cudaError_t launch_bf16(const Args<bf16>& a, const Plan& p, cudaStream_t stream) {
  if (p.smem > 232448 || p.grid > 0x7fffffffL) return cudaErrorInvalidValue;
  Maps maps = {};
  if (hop::encode_slabs(&maps.w, a.w, (uint64_t)3 * a.C, (uint64_t)a.C))
    return cudaErrorInvalidValue;
  for (int i = 0; i < 2; ++i)
    if (a.q[i].C && hop::encode_slabs(&maps.k[i], a.q[i].k, (uint64_t)a.q[i].C, (uint64_t)a.C))
      return cudaErrorInvalidValue;
  auto kernel = temporal_conv_bf16<P, NC, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)p.grid, warps_of(P) * 32, p.smem, stream>>>(a, maps);
  return cudaGetLastError();
}

template <int NC, int T>
cudaError_t launch_bf16(const Args<bf16>& a, const Plan& p, cudaStream_t s) {
  if (p.P == 128) return launch_bf16<128, NC, T>(a, p, s);
  if (p.P == 64) return launch_bf16<64, NC, T>(a, p, s);
  if (p.P == 32) return launch_bf16<32, NC, T>(a, p, s);
  if (p.P == 16) return launch_bf16<16, NC, T>(a, p, s);
  return cudaErrorInvalidValue;
}

cudaError_t launch_bf16(const Args<bf16>& a, const Plan& p, cudaStream_t s) {
  if (p.NC == 128) return p.T == 2 ? launch_bf16<128, 2>(a, p, s) : launch_bf16<128, 1>(a, p, s);
  return p.T == 2 ? launch_bf16<64, 2>(a, p, s) : launch_bf16<64, 1>(a, p, s);
}

// -- float32 (tests only): a plain CUDA-core implicit GEMM --

// The same operands and layouts as the bf16 body; taps, then the skip
// parts, in 32-channel steps of a 64-pixel x 64-channel tile.
__global__ void __launch_bounds__(THREADS) temporal_conv_f32(const Args<float> a) {
  using T = float;
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int bf = blockIdx.x / a.tiles, tile = blockIdx.x % a.tiles;
  const int b = bf / a.F, f = bf % a.F;
  const int C = a.C, S = a.H * a.W, s0 = tile * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const long frame = a.Wp ? (long)(a.H + 2) * a.Wp : S;

  // each thread gathers the same two positions for the whole K loop
  constexpr int SLOTS = (BM * BK) / (THREADS * 8);
  int rrow[SLOTS], rcg[SLOTS];
  long rpos[SLOTS];  // row within a slab, -1 past the interior
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int idx = tid + k * THREADS;
    rrow[k] = idx / (BK / 8);
    rcg[k] = (idx % (BK / 8)) * 8;
    const int s = s0 + rrow[k];
    rpos[k] = s < S ? pos_of(s, a.W, a.Wp) : -1;
  }

  Accum<T> acc;
  acc.zero();
  for (int t = 0; t < 3; ++t) {
    const int ff = f + t - 1;
    const bool frame_ok = ff >= 0 && ff < a.F;
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        if (frame_ok && rpos[k] >= 0)
          copy8(&As[rrow[k]][rcg[k]], a.x + (((long)b * a.F + ff) * frame + rpos[k]) * C + c0 +
                                          rcg[k]);
        else
          zero8(&As[rrow[k]][rcg[k]]);  // the frame padding
      }
      load_b_tile<T>(Bs, a.w, (long)t * C + c0, C, n0);
      __syncthreads();
      acc.step(As, Bs);
      __syncthreads();
    }
  }
  for (int part = 0; part < 2; ++part) {
    const Skip<T> q = a.q[part];
    for (int c0 = 0; c0 < q.C; c0 += BK) {
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        if (rpos[k] >= 0)
          copy8(&As[rrow[k]][rcg[k]], q.x + ((long)bf * frame + rpos[k]) * q.C + c0 + rcg[k]);
        else
          zero8(&As[rrow[k]][rcg[k]]);
      }
      load_b_tile<T>(Bs, q.k, c0, C, n0);
      __syncthreads();
      acc.step(As, Bs);
      __syncthreads();
    }
  }
  acc.store(Cs);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int s = s0 + r;
    float v = 0.f;
    if (s < S) {
      const long o = ((long)bf * frame + pos_of(s, a.W, a.Wp)) * C + n0 + c;
      float off = a.bias[n0 + c];
      if (a.emb) off += a.emb[(long)b * C + n0 + c];
      v = Cs[r][c] + off;
      if (a.sbias) v += a.sbias[n0 + c];
      if (a.res) v += a.res[o];
      a.y[o] = v;
      if (a.Wp) zero_pad_cols(a.y, o, s % a.W, a.W, a.Wp, C);
    }
    Cs[r][c] = v;  // positions past the interior count as zero in the statistics
  }
  if (!a.partial) return;
  __syncthreads();
  const int col = tid % BN, which = tid / BN;  // 0: sum, 1: sum of squares
  float sum = 0.f;
  for (int r = 0; r < BM; ++r) {
    const float v = Cs[r][col];
    sum += which ? v * v : v;
  }
  a.partial[(((long)bf * a.tiles + tile) * 2 + which) * C + n0 + col] = sum;
}

// both entries, from {x, w, bias, emb, res, x0, k0, x1, k1, sbias, y,
// partial, stats}: the float32 body on 64-pixel tiles, or the bf16 body on
// the plan's; then the statistics' second pass
template <typename T>
Args<T> args_from(const void* const* p, const int* skipC, int F, int H, int W, int Wp, int C) {
  Args<T> a = {static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
               static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
               static_cast<const T*>(p[4]), {}, static_cast<const float*>(p[9]),
               static_cast<T*>(const_cast<void*>(p[10])),
               static_cast<float*>(const_cast<void*>(p[11])), F, H, W, Wp, C, 0};
  skips_from(p + 5, skipC, a.q);
  return a;
}

int launch(const void* const* p, const int* skipC, int B, int F, int H, int W, int Wp, int C,
           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long slabs = (long)B * F;
  const int S = H * W;
  int tiles;
  cudaError_t err;
  if (dtype == 0) {
    Args<float> a = args_from<float>(p, skipC, F, H, W, Wp, C);
    tiles = a.tiles = (S + BM - 1) / BM;
    temporal_conv_f32<<<dim3((unsigned)(slabs * tiles), (unsigned)(C / BN)), THREADS, 0, s>>>(a);
    err = cudaGetLastError();
  } else if (dtype == 1) {
    const Plan plan = plan_of(B, F, S, C);
    Args<bf16> a = args_from<bf16>(p, skipC, F, H, W, Wp, C);
    tiles = a.tiles = plan.tiles;
    err = launch_bf16(a, plan, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || !p[11]) return (int)err;
  return (int)reduce_tiles(static_cast<const float*>(p[11]),
                           static_cast<float*>(const_cast<void*>(p[12])), slabs, C, tiles, s);
}

}  // namespace
}  // namespace v2a

// K2. dtype: 0 = float32, 1 = bfloat16. x, res (B, F, S, C); w (3 C, C);
// bias (C) and emb (B, C) float32. emb, res, partial / stats may be null;
// partial holds B * F * tiles * 2 * C floats (tiles: the plan's per slab,
// `v2a_temporal_conv_plan`, for bf16; ceil(S / 64) for float32), stats
// B * F * 2 * C. Needs C % 64 == 0, 16-byte aligned contiguous buffers.
extern "C" int v2a_temporal_conv3(const void* x, const void* w, const void* bias,
                                  const void* emb, const void* res, void* y, void* partial,
                                  void* stats, int B, int F, int S, int C, int dtype,
                                  void* stream) {
  if (B <= 0 || F <= 0 || S <= 0 || C <= 0 || C % 64) return (int)cudaErrorInvalidValue;
  const void* p[13] = {x,       w,       bias,    emb, res,     nullptr, nullptr,
                       nullptr, nullptr, nullptr, y,   partial, stats};
  const int skipC[2] = {0, 0};
  return v2a::launch(p, skipC, B, F, 1, S, 0, C, dtype, stream);
}

// K4b. dtype as K2's. x, res (B, F, H+2, Wp, C); w (3 C, C); bias (C) and
// emb (B, C) float32; skip part i: s_i (B, F, H+2, Wp, Cs_i), k_i (Cs_i, C),
// Cs_i = 0 (null pointers) when absent; sbias (C) float32 with any skip
// part. emb, res, sbias, partial / stats may be null; partial and stats as
// K2's with S = H * W. Needs C % 64 == 0, Cs_i % 32 == 0, Wp % 8 == 0,
// Wp >= W + 2, 16-byte aligned contiguous buffers.
extern "C" int v2a_temporal_conv_padded(const void* x, const void* w, const void* bias,
                                        const void* emb, const void* res, const void* s0,
                                        const void* k0, const void* s1, const void* k1,
                                        const void* sbias, void* y, void* partial, void* stats,
                                        int B, int F, int H, int W, int Wp, int C, int Cs0,
                                        int Cs1, int dtype, void* stream) {
  if (B <= 0 || F <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 64 || Cs0 < 0 || Cs0 % 32 ||
      Cs1 < 0 || Cs1 % 32 || Wp % 8 || Wp < W + 2 || ((Cs0 || Cs1) && !sbias) ||
      (Cs0 && (!s0 || !k0)) || (Cs1 && (!s1 || !k1)))
    return (int)cudaErrorInvalidValue;
  const void* p[13] = {x, w, bias, emb, res, s0, k0, s1, k1, sbias, y, partial, stats};
  const int skipC[2] = {Cs0, Cs1};
  return v2a::launch(p, skipC, B, F, H, W, Wp, C, dtype, stream);
}

// The bf16 body's plan at (B, F, S = H * W interior pixels, C): out =
// {pixels, frames per CTA, output channels per CTA, tiles per slab, grid,
// shared memory bytes}, as `temporal_conv_plan` in ops/resblock_kernels.py.
extern "C" int v2a_temporal_conv_plan(int B, int F, int S, int C, long long* out) {
  if (B <= 0 || F <= 0 || S <= 0 || C <= 0 || C % 64) return (int)cudaErrorInvalidValue;
  const v2a::Plan p = v2a::plan_of(B, F, S, C);
  const long long v[6] = {p.P, p.T, p.NC, p.tiles, p.grid, (long long)p.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}
