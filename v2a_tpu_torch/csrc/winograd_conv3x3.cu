// K14: y = conv3x3_same(x) + bias on (N, H, W, C) -> (N, H, W, D) by
// Winograd F(2x2, 3x3), H and W even: K10's function with 16/9 the products
// of a direct conv spread over 4x fewer rows (2.25x fewer multiplies).
//
// Replaces the TPU kernel `winograd_conv3x3`
// (v2a_tpu/ops/resblock_kernels.py:3163, body `_winograd_kernel` :3062).
//
// Rounding, as the TPU body rounds. Per 2x2 output patch, d is its 4x4
// input patch (rows and cols -1 .. 2 around it, zero outside the frame), in
// float32:
//   t_a = row combo a of d      (d0 - d2, d1 + d2, d2 - d1, d1 - d3)
//   U_ab = bf16(col combo b of t_a) (the same four combos over the cols)
//   M_ab = U_ab @ W_ab           the 16 products, float32 sums over all C,
//                                W_ab = bf16(G g G^T) (made on the host)
//   Y_rc = sum over (a, b) in order of +-M_ab (A^T rows [1,1,1,0], [0,1,-1,-1]),
//          in float32
//   y = bf16(Y_rc + bias)        one rounding
//
// What bounds it on the H100: operations from 64^2 x 256 on, bytes at
// 128^2 x 128 (6.6e10 FLOP of transform-domain products against ~0.37 GB
// at N = 56). The bf16 body, on hopper.cuh's primitives:
//
// - The input staged once. A CTA owns a tile of PT 2x2-output patches
//   (`hop::tile_of` over the patch grid: 8 x 8 patches with sixteen warps;
//   4 x 8 or 4 x 4 with eight) x NC output channels (128, or 64 where 128
//   does not divide D). Its raw (2 th + 2) x (2 tw + 2) window comes by
//   cp.async (zero outside the frame) in slices of 64 channels (128-byte
//   pixel rows). Where the window of all of C fits shared memory it stays
//   resident for the 16 components; otherwise its slices stream through a
//   3-slice ring, once per component. The launch plan (`winograd_plan` in
//   ops/resblock_kernels.py, mirrored by `plan_of` here) picks the tile and
//   the mode.
// - The components from shared memory, in component-outer order as the TPU
//   body runs them. A pipeline step is one component x one 64-channel slice:
//   all threads form the step's U_ab tile once (four 16-byte window reads
//   per 8 channels, the combos in float32 with __fadd_rn / __fsub_rn,
//   constants per component, rounded to bf16) into a double-buffered A tile
//   (64-byte rows, `row64`) a step ahead of its products; its two (32 x NC)
//   W_ab slabs come by TMA through a 3-stage ring whose stages complete on
//   mbarriers; one CTA barrier a step.
// - The products and parities in registers. M_ab is accumulated by mma.sync
//   m16n8k16 (bf16 in, float32 sums) over the component's slices; after its
//   last slice each thread adds +-M_ab into the four output-parity
//   accumulators it holds in the same fragment layout (80 floats a thread).
//   No float32 tile goes through shared memory until the epilogue: bias, one
//   rounding, the 2x2 patches staged as pixel rows and written with 16-byte
//   stores.
//
// Where the time goes (PERF.md, section 5): with the products, the weight ring
// and the transforms all cut, a 128^2 launch still takes a quarter of its
// time (one CTA an SM: the window's load and the output's store do not
// overlap the products); the weight slabs, which each CTA reads once per
// 64 channels and component, are the next term.
//
// The float32 body (tests only) stays the plain CUDA-core form of
// common.cuh: each 32-channel step gathers the four input values a patch
// needs from device memory.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace v2a {
namespace {

using hop::bf16;

// row (and col) combo k of a 4-vector: v[i1(k)] + v[i2(k)] where plus(k),
// else v[i1(k)] - v[i2(k)] (d0 - d2, d1 + d2, d2 - d1, d1 - d3); output
// parity r takes component a with sign at_sign(r, a) (A^T's rows
// [1, 1, 1, 0], [0, 1, -1, -1]; 0: not at all). The bf16 body takes them as
// compile-time constants per component (`for_component`).
__host__ __device__ constexpr int i1(int k) { return k == 0 ? 0 : k == 2 ? 2 : 1; }
__host__ __device__ constexpr int i2(int k) { return k < 2 ? 2 : k == 2 ? 1 : 3; }
__host__ __device__ constexpr bool plus(int k) { return k == 1; }
__host__ __device__ constexpr int at_sign(int r, int a) {
  return r == 0 ? (a < 3 ? 1 : 0) : (a == 0 ? 0 : a == 1 ? 1 : -1);
}
__device__ __forceinline__ float combo(float x, float y, bool p) {
  return p ? __fadd_rn(x, y) : __fsub_rn(x, y);
}
template <bool P>
__device__ __forceinline__ float combo(float x, float y) {
  return combo(x, y, P);
}
// y +- m in float32 by sign SG (0: nothing), as __fadd_rn(y, SG * m) rounds
template <int SG, int NT>
__device__ __forceinline__ void add_parity(float (&y)[NT][4], const float (&m)[NT][4]) {
  if constexpr (SG != 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        y[nt][i] = SG > 0 ? __fadd_rn(y[nt][i], m[nt][i]) : __fsub_rn(y[nt][i], m[nt][i]);
  }
}
template <int V>
using IC = std::integral_constant<int, V>;
// f(IC<a>, IC<b>) for component ab = 4 a + b, so that its combos and signs
// are constants
template <class Fn>
__device__ __forceinline__ void for_component(int ab, Fn&& f) {
  switch (ab) {
    case 0: f(IC<0>{}, IC<0>{}); break;
    case 1: f(IC<0>{}, IC<1>{}); break;
    case 2: f(IC<0>{}, IC<2>{}); break;
    case 3: f(IC<0>{}, IC<3>{}); break;
    case 4: f(IC<1>{}, IC<0>{}); break;
    case 5: f(IC<1>{}, IC<1>{}); break;
    case 6: f(IC<1>{}, IC<2>{}); break;
    case 7: f(IC<1>{}, IC<3>{}); break;
    case 8: f(IC<2>{}, IC<0>{}); break;
    case 9: f(IC<2>{}, IC<1>{}); break;
    case 10: f(IC<2>{}, IC<2>{}); break;
    case 11: f(IC<2>{}, IC<3>{}); break;
    case 12: f(IC<3>{}, IC<0>{}); break;
    case 13: f(IC<3>{}, IC<1>{}); break;
    case 14: f(IC<3>{}, IC<2>{}); break;
    default: f(IC<3>{}, IC<3>{}); break;
  }
}

// warps a CTA: sixteen for 64 patches x 128 output channels (16 x 32 and
// 80 accumulators a warp, the most 128 registers a thread hold), else eight
__host__ __device__ constexpr int warps_of(int PT, int NC) {
  return PT == 64 && NC == 128 ? 16 : 8;
}
constexpr int KC = 64;       // channels a step (two 32-deep products), a window slice
constexpr int BSTAGES = 3;   // weight ring: a step's two slabs a stage
constexpr int WRING = 3;     // streamed window slices
constexpr int MAX_SMEM = 232448;

// the launch: PT patches a tile, NC channels a CTA, window resident or streamed
struct Plan {
  int PT, NC, resident;
  hop::Tile t;  // over the (H/2, W/2) patch grid
  size_t smem;
  long grid;
};

__host__ __device__ inline int window_px(const hop::Tile& t) {
  return (2 * t.th + 2) * (2 * t.tw + 2);
}
// the weight ring, two buffers of two 32-channel A tiles, the window and the
// ring's mbarriers (the epilogue's 4 parities x PT x NC tile aliases them),
// after up to 896 bytes that align the 128-byte aligned base to the TMA
// swizzle's period (1024)
inline size_t smem_of(int PT, int NC, const hop::Tile& t, int C, int resident) {
  const int nq = (C + KC - 1) / KC;
  const size_t win = (size_t)(resident ? nq : WRING) * window_px(t) * KC * 2;
  const size_t ring = (size_t)BSTAGES * 2 * hop::SLAB_ROWS * NC * 2;
  const size_t at = (size_t)2 * 2 * PT * 64;
  const size_t main = ring + at + win + 8 * BSTAGES;
  const size_t out = (size_t)4 * PT * NC * 2;
  return hop::ALIGN_PAD + (main > out ? main : out);
}

// `winograd_plan` (ops/resblock_kernels.py): of 64, 32 and 16 patches a
// tile with the window resident, then the same streamed, whose shared
// memory fits (a larger tile only where it needs fewer tiles than the next
// smaller one), the first whose grid has a CTA per SM (132), else the one
// with the largest grid
inline Plan plan_of(int N, int H, int W, int C, int D) {
  const int NC = D % 128 == 0 ? 128 : 64;
  const int pts[6] = {64, 32, 16, 64, 32, 16}, res[6] = {1, 1, 1, 0, 0, 0};
  Plan best{};
  bool have = false;
  for (int i = 0; i < 6; ++i) {
    Plan p;
    p.PT = pts[i];
    p.NC = NC;
    p.resident = res[i];
    p.t = hop::tile_of(H / 2, W / 2, p.PT);
    p.smem = smem_of(p.PT, NC, p.t, C, p.resident);
    p.grid = (long)N * p.t.tiles * (D / NC);
    if (p.smem > (size_t)MAX_SMEM ||
        (p.PT > 16 && p.t.tiles >= hop::tile_of(H / 2, W / 2, p.PT / 2).tiles))
      continue;
    if (p.grid >= 132) return p;
    if (!have || p.grid > best.grid) best = p;
    have = true;
  }
  if (!have) best.PT = 0;
  return best;
}

// PT patches x NC channels a CTA of WARPS warps: WM = PT / 16 warps over
// the patch rows (one m16 tile each), the rest over the NC columns
template <int PT, int NC, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
winograd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ wt,
              const float* __restrict__ bias, bf16* __restrict__ y, int H, int W, int C, int D,
              int resident, const __grid_constant__ CUtensorMap wmap) {
  constexpr int NTHR = WARPS * 32;
  constexpr int WM = PT / 16, WN = WARPS / WM;  // warps over patch rows, cols
  constexpr int NT = NC / 8 / WN;               // n8 tiles a warp (one m16 tile)
  constexpr int SLAB = hop::slab_bytes<NC>(), AT_B = PT * 64, RB = NC * 2;
  constexpr int VF = (PT * 8 + NTHR - 1) / NTHR;  // U vectors a thread forms a step
  static_assert(NT >= 1 && WM * WN == WARPS, "tile");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);

  const hop::Tile t = hop::tile_of(H / 2, W / 2, PT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int slices = D / NC;
  const int cid = blockIdx.x / slices, n0 = (blockIdx.x % slices) * NC;
  const int n = cid / t.tiles, tile = cid % t.tiles;
  const int py0 = (tile / t.tiles_w) * t.th, px0 = (tile % t.tiles_w) * t.tw;
  const int ww2 = 2 * t.tw + 2, R = (2 * t.th + 2) * ww2;
  const int nq = (C + KC - 1) / KC, nsteps = 16 * nq;
  const int wsb = R * KC * 2;  // bytes of one window slice
  const uint32_t b_s = hop::smem_u32(smem);
  const uint32_t a_s = b_s + BSTAGES * 2 * SLAB;
  unsigned char* abuf = smem + BSTAGES * 2 * SLAB;
  unsigned char* win = abuf + 4 * AT_B;
  const uint32_t w_s = hop::smem_u32(win);
  // the weight ring's mbarriers, one a stage, and each one's next phase
  const uint32_t bar_s = w_s + (resident ? nq : WRING) * wsb;
  uint32_t bph = 0;
  const bf16* xn = x + (long)n * H * W * C;

  // this thread's U vectors, fixed per launch: window byte offset of its
  // patch's input (0, 0) and 8-channel group (-1: past the tile's patches;
  // -2: no vector), its A-tile byte offset, its channel group
  int foff[VF], aoff[VF], fcg[VF];
#pragma unroll
  for (int i = 0; i < VF; ++i) {
    const int v = tid + i * NTHR, m = v >> 3, cg = v & 7;
    fcg[i] = cg;
    aoff[i] = (cg >> 2) * AT_B + hop::row64(m, cg & 3);
    foff[i] = v >= PT * 8 ? -2
              : m < t.th * t.tw ? (2 * (m / t.tw) * ww2 + 2 * (m % t.tw)) * 128 + cg * 16
                                : -1;
  }

  // window slice q (channels 64 q .. + 64; zero outside the frame) into slot
  auto issue_window = [&](int q, int slot) {
    const uint32_t base = w_s + slot * wsb;
    for (int v = tid; v < R * 8; v += NTHR) {
      const int pix = v >> 3, cg = v & 7, c = q * KC + cg * 8;
      if (c >= C) continue;
      const int hh = 2 * py0 - 1 + pix / ww2, wc = 2 * px0 - 1 + pix % ww2;
      const bool in = hh >= 0 && hh < H && wc >= 0 && wc < W;
      hop::cp_async16_or_zero(base + pix * 128 + cg * 16,
                              in ? xn + ((long)hh * W + wc) * C + c : x, in);
    }
  };
  // the window slice step s forms its tile from: resident, slice q in slot
  // q, issued for the first component only; streamed, slot s % WRING
  auto issue_window_of = [&](int s) {
    if (resident && s < nq) issue_window(s, s);
    if (!resident) issue_window(s % nq, s % WRING);
  };
  // step s = (component s / nq, slice s % nq): its slabs of W_ab, by TMA
  // from one thread, completing on the stage's mbarrier
  auto issue_b = [&](int s) {
    const int q = s % nq, kc = C - q * KC < KC ? C - q * KC : KC;
    if (tid == 0)
      hop::tma_slabs<NC>(b_s + (s % BSTAGES) * 2 * SLAB, &wmap, (s / nq) * C + q * KC, 32,
                         kc / 32, n0, bar_s + 8 * (s % BSTAGES));
  };
  // step s's U_ab tile into A buffer buf: patch m, 8 channels a vector
  auto form = [&](int s, int buf) {
    const int q = s % nq, kc = C - q * KC < KC ? C - q * KC : KC;
    const unsigned char* ws = win + (resident ? q : s % WRING) * wsb;
    for_component(s / nq, [&](auto a_, auto b_) {
      constexpr int ca = decltype(a_)::value, cb = decltype(b_)::value;
      const int o11 = (i1(ca) * ww2 + i1(cb)) * 128, o21 = (i2(ca) * ww2 + i1(cb)) * 128;
      const int o12 = (i1(ca) * ww2 + i2(cb)) * 128, o22 = (i2(ca) * ww2 + i2(cb)) * 128;
#pragma unroll
      for (int i = 0; i < VF; ++i) {
        if (foff[i] == -2 || fcg[i] * 8 >= kc) continue;
        float u[8];
        if (foff[i] >= 0) {
          float d11[8], d21[8], d12[8], d22[8];
          load8(reinterpret_cast<const bf16*>(ws + foff[i] + o11), d11);
          load8(reinterpret_cast<const bf16*>(ws + foff[i] + o21), d21);
          load8(reinterpret_cast<const bf16*>(ws + foff[i] + o12), d12);
          load8(reinterpret_cast<const bf16*>(ws + foff[i] + o22), d22);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float t1 = combo<plus(ca)>(d11[e], d21[e]);  // t_a at col k1
            const float t2 = combo<plus(ca)>(d12[e], d22[e]);  // t_a at col k2
            u[e] = combo<plus(cb)>(t1, t2);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) u[e] = 0.f;  // a row past the tile's patches
        }
        store8(reinterpret_cast<bf16*>(abuf + buf * 2 * AT_B + aoff[i]), u);  // U_ab in bf16
      }
    });
  };

  float mab[1][NT][4], yp[4][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mab[0][nt][i] = 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) yp[p][nt][i] = 0.f;
    }
  const int arow = wm * 16 + (lane & 15);

  if (tid == 0) {
    for (int i = 0; i < BSTAGES; ++i) hop::mbar_init(bar_s + 8 * i, 1);
    hop::fence_mbar_init();
  }
  __syncthreads();
  // the window slices of steps 0 .. WRING - 1, the slabs of steps 0 ..
  // BSTAGES - 2
  for (int s = 0; s < WRING && s < nsteps; ++s) issue_window_of(s);
  hop::cp_commit();
  for (int s = 0; s < BSTAGES - 1 && s < nsteps; ++s) issue_b(s);
  hop::cp_wait<0>();
  __syncthreads();
  form(0, 0);
  for (int s = 0; s < nsteps; ++s) {
    // step s's slabs and U tile are in place; what step s - 1 read may be
    // refilled (each thread's reads ordered before the TMA writes). A window
    // slice is issued WRING (3) steps ahead, so the one the next tile is
    // formed from has landed.
    hop::mbar_wait(bar_s + 8 * (s % BSTAGES), (bph >> (s % BSTAGES)) & 1);
    bph ^= 1u << (s % BSTAGES);
    hop::cp_wait<1>();
    hop::fence_proxy_async();
    __syncthreads();
    if (s + BSTAGES - 1 < nsteps) issue_b(s + BSTAGES - 1);
    if (s + WRING < nsteps) issue_window_of(s + WRING);
    hop::cp_commit();
    if (s + 1 < nsteps) form(s + 1, (s + 1) & 1);
    const int q = s % nq, kc = C - q * KC < KC ? C - q * KC : KC;
    const uint32_t at = a_s + (s & 1) * 2 * AT_B, bb = b_s + (s % BSTAGES) * 2 * SLAB;
    for (int u = 0; u < kc / 32; ++u)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t af[1][4];
        hop::ldsm_x4(at + u * AT_B + hop::row64(arow, 2 * kk + (lane >> 4)), af[0]);
        hop::mma_slab<1, NT>(mab, bb + u * SLAB, kk, af, wn * (NC / WN), lane);
      }
    if (q == nq - 1) {
      // the component's last slice: +-M_ab into each output parity (pr, pc),
      // in (a, b) order
      for_component(s / nq, [&](auto a_, auto b_) {
        constexpr int ca = decltype(a_)::value, cb = decltype(b_)::value;
        add_parity<at_sign(0, ca) * at_sign(0, cb)>(yp[0], mab[0]);
        add_parity<at_sign(0, ca) * at_sign(1, cb)>(yp[1], mab[0]);
        add_parity<at_sign(1, ca) * at_sign(0, cb)>(yp[2], mab[0]);
        add_parity<at_sign(1, ca) * at_sign(1, cb)>(yp[3], mab[0]);
      });
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) mab[0][nt][i] = 0.f;
    }
  }
  hop::cp_wait<0>();
  __syncthreads();

  // + bias, one rounding, staged as rows (parity, patch) of NC (chunks ^ (row & 7))
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wn * (NC / WN) + nt * 8 + (lane & 3) * 2;
    const float b0 = bias[n0 + col], b1 = bias[n0 + col + 1];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = p * PT + wm * 16 + (lane >> 2) + hh * 8;
        *reinterpret_cast<__nv_bfloat162*>(smem + r * RB + (((col >> 3) ^ (r & 7)) << 4) +
                                           (col & 7) * 2) =
            __floats2bfloat162_rn(__fadd_rn(yp[p][nt][2 * hh], b0),
                                  __fadd_rn(yp[p][nt][2 * hh + 1], b1));
      }
  }
  __syncthreads();
  for (int v = tid; v < 4 * PT * (NC / 8); v += NTHR) {
    const int r = v / (NC / 8), ch = v % (NC / 8);
    const int p = r / PT, m = r % PT;
    const int py = py0 + m / t.tw, px = px0 + m % t.tw;
    if (m >= t.th * t.tw || py >= H / 2 || px >= W / 2) continue;
    const int oh = 2 * py + (p >> 1), ow = 2 * px + (p & 1);
    *reinterpret_cast<uint4*>(y + (((long)n * H + oh) * W + ow) * D + n0 + ch * 8) =
        *reinterpret_cast<const uint4*>(smem + r * RB + ((ch ^ (r & 7)) << 4));
  }
}

template <int PT, int NC>
cudaError_t launch_bf16(const Plan& p, const void* x, const void* wt, const void* bias, void* y,
                        int H, int W, int C, int D, cudaStream_t stream) {
  constexpr int WARPS = warps_of(PT, NC);
  auto kernel = winograd_bf16<PT, NC, WARPS>;
  CUtensorMap wmap;
  if (hop::encode_slabs(&wmap, wt, (uint64_t)16 * C, (uint64_t)D)) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)p.grid, WARPS * 32, p.smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt), static_cast<const float*>(bias),
      static_cast<bf16*>(y), H, W, C, D, p.resident, wmap);
  return cudaGetLastError();
}

// -- float32 (tests only): the plain CUDA-core form --

__device__ __forceinline__ void load8_or_zero(const float* __restrict__ x, int r, int c, int H,
                                              int W, int C, float v[8]) {
  if (r < 0 || r >= H || c < 0 || c >= W) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
    return;
  }
  load8(x + ((long)r * W + c) * C, v);
}

__global__ void __launch_bounds__(THREADS)
winograd_f32(const float* __restrict__ x, const float* __restrict__ wt,
             const float* __restrict__ bias, float* __restrict__ y, int H, int W, int C, int D,
             int tiles) {
  using T = float;
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
        const int r1 = rr0[s] + i1(a), r2 = rr0[s] + i2(a);
        const int k1 = rc0[s] + i1(b), k2 = rc0[s] + i2(b);
        float d11[8], d21[8], d12[8], d22[8];
        const T* xc = xn + c0 + rcg[s];
        load8_or_zero(xc, r1, k1, H, W, C, d11);
        load8_or_zero(xc, r2, k1, H, W, C, d21);
        load8_or_zero(xc, r1, k2, H, W, C, d12);
        load8_or_zero(xc, r2, k2, H, W, C, d22);
        float u[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float t1 = combo(d11[i], d21[i], plus(a));
          const float t2 = combo(d12[i], d22[i], plus(a));
          u[i] = combo(t1, t2, plus(b));
        }
        store8(dst, u);
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
          const int sg = at_sign(pr, a) * at_sign(pc, b);
          if (sg == 0) continue;
          float* yv = Ys + ((pr * 2 + pc) * BM + r) * BN + c;
          const float contrib = sg > 0 ? m : -m;
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
    y[(((long)n * H + oh) * W + ow) * D + n0 + c] = __fadd_rn(Ys[idx], bias[n0 + c]);
  }
}

cudaError_t launch_f32(const void* x, const void* wt, const void* bias, void* y, int N, int H,
                       int W, int C, int D, cudaStream_t stream) {
  const int tiles = ((H / 2) * (W / 2) + BM - 1) / BM;
  const size_t dyn = (size_t)4 * BM * BN * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(winograd_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(N * tiles), (unsigned)(D / BN));
  winograd_f32<<<grid, THREADS, dyn, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<float*>(y), H, W, C, D, tiles);
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
  if (N <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || C <= 0 || C % 32 || D <= 0 || D % 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)v2a::launch_f32(x, wt, bias, y, N, H, W, C, D, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  using namespace v2a;
  const Plan p = plan_of(N, H, W, C, D);
  if (!p.PT || p.grid > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  if (p.NC == 128) {
    if (p.PT == 64) return (int)launch_bf16<64, 128>(p, x, wt, bias, y, H, W, C, D, s);
    if (p.PT == 32) return (int)launch_bf16<32, 128>(p, x, wt, bias, y, H, W, C, D, s);
    return (int)launch_bf16<16, 128>(p, x, wt, bias, y, H, W, C, D, s);
  }
  if (p.PT == 64) return (int)launch_bf16<64, 64>(p, x, wt, bias, y, H, W, C, D, s);
  if (p.PT == 32) return (int)launch_bf16<32, 64>(p, x, wt, bias, y, H, W, C, D, s);
  return (int)launch_bf16<16, 64>(p, x, wt, bias, y, H, W, C, D, s);
}

// The bf16 launch plan at a shape, for the wrapper's log and the card
// tests: out = {patches a tile, NC, resident, grid, shared memory bytes,
// patch-tile rows, patch-tile cols}. Returns 0, or an error code where no
// plan fits.
extern "C" int v2a_winograd_plan(int N, int H, int W, int C, int D, long long* out) {
  if (N <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || C <= 0 || C % 32 || D <= 0 || D % 64)
    return (int)cudaErrorInvalidValue;
  const v2a::Plan p = v2a::plan_of(N, H, W, C, D);
  if (!p.PT) return (int)cudaErrorInvalidValue;
  const long long v[7] = {p.PT, p.NC, p.resident, p.grid, (long long)p.smem, p.t.th, p.t.tw};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}
