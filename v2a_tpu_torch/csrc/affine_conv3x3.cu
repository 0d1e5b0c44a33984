// K1: y = conv3x3_same(act(x)) + bias on (N, H, W, C) -> (N, H, W, D),
// K4a: y = sum_i conv3x3_same(act_i(x_i)) + bias over a padded stream,
// x_i (N, H+2, Wp, C_i) -> y (N, H+2, Wp, D), one or two channel parts,
// K10: y = conv3x3_same(x) + bias on (N, H, W, C) -> (N, H, W, D), and
// K8: y = conv3x3_stride2_same(act(x)) + bias between padded streams,
// x (N, H+2, Wp, C) -> y (N, H/2+2, Wp2, D), and
// K5: y = conv3x3_same(nearest_2x(act(x))) + bias from a low-res padded
// stream x (N, H+2, Wp, C) into the high-res one y (N, 2H+2, Wph, D).
//
// Replaces the TPU kernels `fused_affine_conv3x3`
// (v2a_tpu/ops/resblock_kernels.py:662, bodies `_affine_conv_kernel` :489 and
// `_affine_conv_banded_kernel` :554), `fused_affine_conv3x3_padded`
// (:902, body `_padded_conv_kernel` :815), `spatial_conv3x3` (:2796, body
// `_spatial3x3_kernel` :2760), `fused_downconv3x3_padded` (:1514, body
// `_downconv_kernel` :1413) and `fused_upconv3x3_padded` (:1314, body
// `_upconv_kernel` :1222).
//
// act(x) = silu(a[n, c] * x + b[n, c]) (mode 2), a[n, c] * x + b[n, c]
// (mode 1) or x (mode 0, plain conv: the forward's plain convs, K10, every
// dgrad, whose (9 C, D) weights are the flipped, transposed kernel), in
// float32 with `affine8`'s arithmetic (no FMA, t * (1 / (1 + e^-t)) with
// __frcp_rn) and rounded to bf16 before the product, as the TPU kernels
// do. The SAME halo is zero AFTER the activation: set by selection, since
// act(0) = silu(b) is not zero. K4a runs modes 1 and 2, K10 mode 0, K8 and
// K5 all three.
//
// What bounds it on the H100: operations (128^2 x 128 -> 128 at N = 28 is
// 1.1e11 FLOP against ~0.12 GB; K8 at 128^2 -> 64^2 is near the balance
// point, 67.6 GFLOP against 0.3 GB). One bf16 body serves all five: the
// conv half of the shared mainloop (conv_tconv_hopper.cuh) without the
// temporal phase, on hopper.cuh's primitives:
//
// - A CTA owns a tile of P output pixels (`hop::tile_of`: 16 x 8 with
//   sixteen warps; 8 x 8, 8 x 4 or 4 x 4 with eight) of one sample x NC
//   output channels (128, or 64 where 128 does not divide D). The launch
//   plan (`affine_conv_plan` in ops/resblock_kernels.py, over the parts'
//   summed C for K4a, with the stride for K8) picks P in {128, 64, 32, 16}:
//   the largest whose grid has a CTA per SM, so a B = 1 request fills the
//   card too.
// - The activation once per element. Per 32-channel chunk, the tile's raw
//   input window (64-byte rows, `row64`) and the chunk's a, b come by
//   cp.async into a 3-stage ring, positions outside the image zero-filled
//   by the copy; affine8 runs once per element there, in place, spread over
//   the three steps of the chunk before it, and rounds to bf16. Positions
//   outside the image keep the copy's zeros: they are never activated
//   (selection). Mode 0 copies no a, b and runs no pass at all; at stride
//   1 its window is one TMA box a chunk (32 channels x (tw+2) x (th+2) at
//   (c0, w0 - 1, h0 - 1, n) of a map over the image, which zero-fills what
//   lies outside it: the SAME halo), with 64-byte swizzle, which is
//   `row64` on the ring's 512-byte-aligned stages, completing on the
//   stage's mbarrier. The nine taps read the one window through ldmatrix
//   at shifted row addresses.
// - A pipeline step is one tap row of one chunk: three 32-deep products,
//   their three (32 x NC) weight slabs copied by TMA (one thread, 2-D boxes,
//   128-byte swizzle) through a 3-stage ring whose stages complete on
//   mbarriers, one CTA barrier a step; mma.sync m16n8k16 (bf16 in, float32
//   sums). TMA took 8-25% off the cp.async ring's times (PERF.md, section 6).
// - The epilogue adds the bias in float32 to the float32 sum, rounds once,
//   stages the tile in shared memory (rows' chunks ^ (row & 7)) and writes
//   it with 16-byte stores.
//
// K10 is K1's entry in mode 0: the same launch, so bit-equal to K1 without
// an affine.
//
// K4a is the same body with three differences (`Wp` > 0):
// - padded addressing: window position (hh, ww) of the interior reads
//   padded (hh + 1, ww + 1). The copy's image-bounds test is exactly the
//   interior: padded rows 0 and H + 1 and the pad cols are never loaded,
//   so whatever they hold (NaN included) cannot reach y;
// - two parts: the step loop walks part 0's chunks, then part 1's, as
//   further steps of the one float32 accumulator, each part with its own
//   a, b and tensor map over its (9 C_i, D) weights; the bias is added
//   once and the sum rounded once. With one part the chunks, their order
//   and the products are K1's, so K4a on a padded copy of an image is
//   bit-equal to K1 on the image;
// - padded output: the interior at padded (h + 1, w + 1), and the tiles at
//   w = 0 and w = W - 1 also write the zero pad cols (col 0, cols W + 1 ..
//   Wp - 1); pad rows are left unwritten.
//
// K8 is K4a's addressing with one part at stride 2 (`S` = 2): output
// interior pixel (i, j) reads interior (2i + di - 1, 2j + dj - 1), K1's
// SAME conv centred on (2i, 2j). Tiles cover the (H/2, W/2) output grid;
// per chunk a tile stages its (2 th + 1) x (2 tw + 1) input window as two
// column-parity planes, the even window cols (tw + 1 wide) then the odd
// ones (tw wide), the TPU kernel's own parity split: tap dj reads plane
// dj & 1 at col j + (dj == 2), so the eight output pixels of an ldmatrix
// read eight consecutive plane rows, conflict-free under `row64` (a
// stride-2 read of one plane would hit each bank group twice). The steps
// (chunk, di, dj, kk) and the epilogue are K1's, so K8's interior is
// bit-equal to K1 on the input's interior at even pixels. The output is
// the half-size padded stream with its pad cols (`Wp2`) zeroed.
//
// K5 is K4a's addressing with one part and the parity tap sets (`UP`).
// Output pixel (2i + p, 2j + p') of the upsampled conv is a 2x2 conv on the
// low-res interior: tap (a, b) reads (i - 1 + p + a, j - 1 + p' + b) with
// the collapsed weights w16[p][p'][a][b] (`upconv_weights` in
// ops/resblock_kernels.py sums the 3x3 taps that land there in the
// kernel's dtype, then the wrapper casts the sums to x's). That is K1's
// SAME conv centred on (i, j) at the taps (di, dj) = (p + a, p' + b). A
// CTA owns a tile of the low-res grid for ONE parity (a grid axis: the four
// parities of a tile adjacent, after its D slices) and stages K1's (th+2)
// x (tw+2) window per chunk; a step is one tap row a of one chunk, its two
// (32 x NC) slabs w16[p][p'][a][0..1], the window read at rows and cols
// shifted by (p + a, p' + b). Per output element the steps are (chunk, a,
// b, kk): K1's (chunk, di, dj, kk) with the five zero taps left out, so a
// parity plane is bit-equal to K1 on the low-res interior with a 3x3
// kernel that holds w16[p][p'] at those four taps and zeros at the other
// five (K1 adds exact zero products there). The epilogue writes pixel
// (i, j) at padded (2i + p + 1, 2j + p' + 1) of the (N, 2H+2, Wph, D)
// stream, each pixel's NC channels one 16-byte-store run; parity p' = 0
// at j = 0 also writes pad col 0, parity p' = 1 at j = W - 1 the pad cols
// past the interior. Each window is staged once per parity (four times a
// tile): the probe's window-refill cut says what that costs.
//
// The float32 body (tests only) stays the plain CUDA-core implicit GEMM of
// common.cuh (`Accum<float>`), for all five: per (part, tap, 32-channel)
// step it gathers the shifted (strided), activated rows of a 64-pixel x
// 64-channel tile (K5: the four taps of its parity, grid z).
#include "common.cuh"
#include "hopper.cuh"

namespace v2a {
namespace {

using hop::bf16;

// warps a CTA: sixteen at 128-pixel tiles, else eight
__host__ __device__ constexpr int warps_of(int P) { return P == 128 ? 16 : 8; }
constexpr int K1_STAGES = 3;     // weight ring: one tap row's three slabs a stage (4 and 5: no faster)
constexpr int K1_WSTAGES = 3;    // window ring: a chunk multiplied, one activated, one in flight

// 64-byte rows of one window stage at stride S: (th+2)(tw+2), or
// (2th+1)(2tw+1) in two column-parity planes
template <int S>
__host__ __device__ inline int window_rows(const hop::Tile& t) {
  return (S * t.th + 3 - S) * (S * t.tw + 3 - S);
}
// one window stage: its rows, then the chunk's a[32], b[32], to 512 bytes
// (the 64-byte swizzle's period, for a TMA box)
template <int S>
__host__ __device__ inline int window_bytes(const hop::Tile& t) {
  return (window_rows<S>(t) * 64 + 2 * 32 * 4 + 511) / 512 * 512;
}
// the weight ring (TMA: aligned to its swizzle's period), the window ring
// and the two rings' mbarriers; the epilogue's P x NC tile aliases them
template <int S>
inline size_t smem_bytes(int P, int NC, const hop::Tile& t) {
  const size_t ring = (size_t)K1_STAGES * 3 * hop::SLAB_ROWS * NC * 2 +
                      (size_t)K1_WSTAGES * window_bytes<S>(t) + 8 * (K1_STAGES + K1_WSTAGES);
  const size_t out = (size_t)P * NC * 2;
  return hop::ALIGN_PAD + (ring > out ? ring : out);
}

// each part's (9 C_i, D) weights in slab boxes (`hop::encode_slabs`), and
// in mode 0 at stride 1 the input image in window boxes
struct Maps {
  CUtensorMap w[2];
  CUtensorMap x;
};

// Parts p0, p1 (p1.C = 0: one part; their `w` unused, the maps carry the
// weights). Wp = 0: K1's unpadded (N, H, W, C) layout in and out; Wp > 0:
// the padded stream (N, H+2, Wp, C_i) in and (N, H/S+2, Wp2, D) out (UP:
// (N, 2H+2, Wp2, D)). The tile grid is (H/S, W/S). Grid: N * tiles * (D /
// NC) CTAs (UP: x 4 parities), the D slices of one tile adjacent.
template <int P, int NC, int S, bool UP>
__global__ void __launch_bounds__(warps_of(P) * 32, P == 128 ? 1 : 2)
affine_conv3x3_bf16(const Part<bf16> p0, const Part<bf16> p1, const float* __restrict__ bias,
                    bf16* __restrict__ y, int H, int W, int Wp, int Wp2, int D, int mode,
                    const __grid_constant__ Maps maps) {
  constexpr int NTHR = warps_of(P) * 32;
  constexpr int WM = P == 128 ? 4 : P >= 32 ? 2 : 1, WN = warps_of(P) / WM;  // warps over rows, cols
  constexpr int MT = P / 16 / WM, NT = NC / 8 / WN;  // m16 and n8 tiles a warp
  constexpr int SLAB = hop::slab_bytes<NC>(), RB = NC * 2;
  // steps a chunk and slabs a step: tap rows of three taps, or (UP) the
  // parity's two tap rows of two
  constexpr int SPC = UP ? 2 : 3, NSL = UP ? 2 : 3;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);

  const int OH = H / S, OW = W / S;  // the output grid
  const hop::Tile t = hop::tile_of(OH, OW, P);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int slices = D / NC;
  const int n0 = (blockIdx.x % slices) * NC;
  const int par = UP ? blockIdx.x / slices % 4 : 0, pi = par >> 1, pj = par & 1;
  const int cid = blockIdx.x / slices / (UP ? 4 : 1);
  const int n = cid / t.tiles, tile = cid % t.tiles;
  const int h0 = (tile / t.tiles_w) * t.th, w0 = (tile % t.tiles_w) * t.tw;
  // the window: wr input rows from (S h0 - 1, S w0 - 1); S = 1, rows of pw0 =
  // tw + 2 pixels; S = 2, the even window cols (pw0 = tw + 1 a row, R0 rows)
  // then the odd ones (tw a row)
  const int wr = S * t.th + 3 - S, pw0 = t.tw + 3 - S, R0 = wr * pw0;
  const int R = window_rows<S>(t), R4 = R * 4;
  const int ih0 = S * h0 - 1, iw0 = S * w0 - 1;
  const int wbytes = window_bytes<S>(t);
  // the layouts: input pixel (hh, ww) of sample n at row (n * XH + hh + pad)
  // * XW + ww + pad, output pixel (i, j) at (n * YH + i + pad) * YW + j + pad
  const int pad = Wp > 0, XH = pad ? H + 2 : H, XW = pad ? Wp : W;
  // UP: the output grid is twice the tile grid
  const int OHy = UP ? 2 * OH : OH, OWy = UP ? 2 * OW : OW;
  const int YH = pad ? OHy + 2 : OHy, YW = pad ? Wp2 : OWy;
  const int nch0 = p0.C / 32, nch = nch0 + p1.C / 32, nsteps = nch * SPC;
  const uint32_t b_s = hop::smem_u32(smem);
  const uint32_t w_s = b_s + K1_STAGES * 3 * SLAB;
  unsigned char* win = smem + K1_STAGES * 3 * SLAB;
  // the weight ring's mbarriers, one a stage, then the window ring's, and
  // each one's next phase
  const uint32_t bar_s = w_s + K1_WSTAGES * wbytes, wbar_s = bar_s + 8 * K1_STAGES;
  uint32_t bph = 0, wph = 0;
  // mode 0 at stride 1: the windows by TMA (`maps.x`, one part)
  const bool tma_win = S == 1 && mode == 0;

  // the input position (hh, ww) of window row pix
  auto at = [&](int pix, int& hh, int& ww) {
    if (S == 1 || pix < R0) {
      hh = ih0 + pix / pw0;
      ww = iw0 + S * (pix % pw0);
    } else {
      const int q = pix - R0;
      hh = ih0 + q / t.tw;
      ww = iw0 + 2 * (q % t.tw) + 1;
    }
  };
  // the raw window of chunk g (zero outside the image) and its a, b into
  // window stage ws; chunks past part 0's are part 1's
  auto issue_window = [&](int g, int ws) {
    const bool second = g >= nch0;
    const Part<bf16> q = second ? p1 : p0;
    const int C = q.C, c0 = (second ? g - nch0 : g) * 32;
    const bf16* xn = q.x + (long)n * XH * XW * C;
    const uint32_t base = w_s + ws * wbytes;
    if (tma_win) {
      if (tid == 0) {
        hop::mbar_expect(wbar_s + 8 * ws, R * 64);
        hop::tma_load_4d(base, &maps.x, c0, w0 - 1, h0 - 1, n, wbar_s + 8 * ws);
      }
      return;
    }
    for (int v = tid; v < R4; v += NTHR) {
      const int pix = v >> 2, ch = v & 3;
      int hh, ww;
      at(pix, hh, ww);
      const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
      hop::cp_async16_or_zero(base + hop::row64(pix, ch),
                              in ? xn + ((long)(hh + pad) * XW + ww + pad) * C + c0 + ch * 8 : xn,
                              in);
    }
    if (mode && tid < 16)
      hop::cp_async16(base + R * 64 + tid * 16,
                      (tid < 8 ? q.a : q.b) + (long)n * C + c0 + (tid & 7) * 4);
  };
  // affine8 in place on vectors [lo, hi) of window stage ws, rounded to
  // bf16; positions outside the image are selected out and keep their zeros
  auto activate = [&](int ws, int lo, int hi) {
    unsigned char* base = win + ws * wbytes;
    const float* ab = reinterpret_cast<const float*>(base + R * 64);
    for (int v = lo + tid; v < hi; v += NTHR) {
      const int pix = v >> 2, ch = v & 3;
      int hh, ww;
      at(pix, hh, ww);
      if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
      bf16* p = reinterpret_cast<bf16*>(base + hop::row64(pix, ch));
      float v8[8];
      load8(p, v8);
      affine8(v8, ab + ch * 8, ab + 32 + ch * 8, mode == 2);
      store8(p, v8);
    }
  };
  // step j's weight slabs: taps (di, 0..2) of chunk g, rows (di * 3 + dj)
  // * C + 32 g .. + 32 of its part's tap-major (9 C, D) weights (UP: taps
  // (a, 0..1) of the parity, rows ((p * 2 + p') * 4 + a * 2 + b) * C + 32 g
  // of the (16 C, D) w16), by TMA from one thread, completing on the
  // stage's mbarrier
  auto issue_b = [&](int j) {
    if (tid == 0) {
      const int g = j / SPC, second = g >= nch0, C = second ? p1.C : p0.C;
      const int row0 = UP ? (par * 4 + (j % SPC) * 2) * C : (j % SPC) * 3 * C;
      hop::tma_slabs<NC>(b_s + (j % K1_STAGES) * 3 * SLAB, &maps.w[second],
                         row0 + (second ? g - nch0 : g) * 32, C, NSL, n0,
                         bar_s + 8 * (j % K1_STAGES));
    }
  };

  // this lane's ldmatrix row of each m16 tile: its window row at tap (0, 0)
  // (S = 2: in the even-col plane; apix1 in the odd one; UP: at tap (p, p'),
  // the parity's first)
  int apix[MT], apix1[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = wm * (P / WM) + mt * 16 + (lane & 15);
    const bool in = m < t.th * t.tw;
    const int i = in ? m / t.tw : 0, j = in ? m % t.tw : 0;
    apix[mt] = S * i * pw0 + j + (UP ? pi * pw0 + pj : 0);
    apix1[mt] = R0 + 2 * i * t.tw + j;
  }
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  if (tid == 0) {
    for (int i = 0; i < K1_STAGES + K1_WSTAGES; ++i) hop::mbar_init(bar_s + 8 * i, 1);
    hop::fence_mbar_init();
  }
  __syncthreads();
  issue_window(0, 0);
  if (nch > 1) issue_window(1, 1);
  hop::cp_commit();
  for (int j = 0; j < K1_STAGES - 1 && j < nsteps; ++j) issue_b(j);
  hop::cp_wait<0>();
  __syncthreads();
  if (mode) activate(0, 0, R4);
  for (int j = 0; j < nsteps; ++j) {
    const int g = j / SPC, di = j % SPC;
    // step j's slabs and chunk g's activated window are in place, and the
    // window a chunk ahead has landed (issued at least two steps ago); the
    // stages step j - 1 read may be refilled (each thread's reads ordered
    // before the TMA writes)
    hop::mbar_wait(bar_s + 8 * (j % K1_STAGES), (bph >> (j % K1_STAGES)) & 1);
    bph ^= 1u << (j % K1_STAGES);
    if (tma_win && di == 0) {
      hop::mbar_wait(wbar_s + 8 * (g % K1_WSTAGES), (wph >> (g % K1_WSTAGES)) & 1);
      wph ^= 1u << (g % K1_WSTAGES);
    }
    hop::cp_wait<1>();
    hop::fence_proxy_async();
    __syncthreads();
    if (j + K1_STAGES - 1 < nsteps) issue_b(j + K1_STAGES - 1);
    if (di == 0 && g + 2 < nch) issue_window(g + 2, (g + 2) % K1_WSTAGES);
    hop::cp_commit();
    // the next chunk's window, a third a step (its raw copy landed a chunk ago)
    if (mode && g + 1 < nch) activate((g + 1) % K1_WSTAGES, di * R4 / SPC, (di + 1) * R4 / SPC);
    const uint32_t wb = w_s + (g % K1_WSTAGES) * wbytes;
    const uint32_t bb = b_s + (j % K1_STAGES) * 3 * SLAB;
#pragma unroll
    for (int dj = 0; dj < NSL; ++dj) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // tap (di, dj)'s row: S = 2, plane dj & 1 at col j + (dj == 2)
          const int r = S == 1 ? apix[mt] + di * pw0 + dj
                        : dj == 1 ? apix1[mt] + di * t.tw : apix[mt] + di * pw0 + dj / 2;
          hop::ldsm_x4(wb + hop::row64(r, 2 * kk + (lane >> 4)), af[mt]);
        }
        hop::mma_slab<MT, NT>(acc, bb + dj * SLAB, kk, af, wn * (NC / WN), lane);
      }
    }
  }
  hop::cp_wait<0>();
  __syncthreads();

  // + bias in float32, one rounding, staged as P rows of NC (chunks ^ (row & 7))
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wn * (NC / WN) + nt * 8 + (lane & 3) * 2;
    const float b0 = bias[n0 + col], b1 = bias[n0 + col + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = wm * (P / WM) + mt * 16 + (lane >> 2) + hh * 8;
        *reinterpret_cast<__nv_bfloat162*>(smem + m * RB + (((col >> 3) ^ (m & 7)) << 4) +
                                           (col & 7) * 2) =
            __floats2bfloat162_rn(acc[mt][nt][2 * hh] + b0, acc[mt][nt][2 * hh + 1] + b1);
      }
  }
  __syncthreads();
  // padded: the tiles at the output's first and last col also zero the pad
  // cols; UP: tile pixel (i, j) is output pixel (2i + p, 2j + p')
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int v = tid; v < P * (NC / 8); v += NTHR) {
    const int m = v / (NC / 8), ch = v % (NC / 8);
    const int i = h0 + m / t.tw, jj = w0 + m % t.tw;
    if (m >= t.th * t.tw || i >= OH || jj >= OW) continue;
    const int oi = UP ? 2 * i + pi : i, oj = UP ? 2 * jj + pj : jj;
    bf16* o = y + (((long)n * YH + oi + pad) * YW + oj + pad) * D + n0 + ch * 8;
    *reinterpret_cast<uint4*>(o) =
        *reinterpret_cast<const uint4*>(smem + m * RB + ((ch ^ (m & 7)) << 4));
    if (pad && oj == 0) *reinterpret_cast<uint4*>(o - D) = zero;
    if (pad && oj == OWy - 1)
      for (int k = 1; k < YW - OWy; ++k) *reinterpret_cast<uint4*>(o + (long)k * D) = zero;
  }
}

template <int P, int NC, int S, bool UP>
cudaError_t launch_bf16(const Part<bf16>* p, const void* bias, void* y, int N, int H, int W,
                        int Wp, int Wp2, int D, int mode, cudaStream_t stream) {
  const hop::Tile t = hop::tile_of(H / S, W / S, P);
  const size_t smem = smem_bytes<S>(P, NC, t);
  const long grid = (long)N * t.tiles * (D / NC) * (UP ? 4 : 1);
  if (smem > 232448 || grid > 0x7fffffffL) return cudaErrorInvalidValue;
  auto kernel = affine_conv3x3_bf16<P, NC, S, UP>;
  Maps maps = {};
  for (int i = 0; i < 2; ++i)
    if (p[i].C &&
        hop::encode_slabs(&maps.w[i], p[i].w, (uint64_t)(UP ? 16 : 9) * p[i].C, (uint64_t)D))
      return cudaErrorInvalidValue;
  if (S == 1 && mode == 0) {  // the image of the one part as (C, W, H, N), past any pads
    const int pad = Wp > 0, XH = pad ? H + 2 : H, XW = pad ? Wp : W;
    const uint64_t C = p[0].C;
    const uint64_t dims[4] = {C, (uint64_t)W, (uint64_t)H, (uint64_t)N};
    const uint64_t strides[3] = {C * 2, C * 2 * XW, C * 2 * XW * XH};
    const uint32_t box[4] = {32, (uint32_t)t.tw + 2, (uint32_t)t.th + 2, 1};
    if (hop::encode_tiled(&maps.x, p[0].x + (pad ? (XW + 1) * C : 0), 4, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_64B))
      return cudaErrorInvalidValue;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, warps_of(P) * 32, smem, stream>>>(
      p[0], p[1], static_cast<const float*>(bias), static_cast<bf16*>(y), H, W, Wp, Wp2, D, mode,
      maps);
  return cudaGetLastError();
}

// the instantiation of the plan's P and the NC that D takes
template <int S, bool UP>
cudaError_t dispatch_bf16(const Part<bf16>* p, const void* bias, void* y, int N, int H, int W,
                          int Wp, int Wp2, int D, int mode, int P, cudaStream_t s) {
  if (D % 128 == 0) {
    if (P == 128) return launch_bf16<128, 128, S, UP>(p, bias, y, N, H, W, Wp, Wp2, D, mode, s);
    if (P == 64) return launch_bf16<64, 128, S, UP>(p, bias, y, N, H, W, Wp, Wp2, D, mode, s);
    if (P == 32) return launch_bf16<32, 128, S, UP>(p, bias, y, N, H, W, Wp, Wp2, D, mode, s);
    if (P == 16) return launch_bf16<16, 128, S, UP>(p, bias, y, N, H, W, Wp, Wp2, D, mode, s);
  } else {
    if (P == 128) return launch_bf16<128, 64, S, UP>(p, bias, y, N, H, W, Wp, Wp2, D, mode, s);
    if (P == 64) return launch_bf16<64, 64, S, UP>(p, bias, y, N, H, W, Wp, Wp2, D, mode, s);
    if (P == 32) return launch_bf16<32, 64, S, UP>(p, bias, y, N, H, W, Wp, Wp2, D, mode, s);
    if (P == 16) return launch_bf16<16, 64, S, UP>(p, bias, y, N, H, W, Wp, Wp2, D, mode, s);
  }
  return cudaErrorInvalidValue;
}

// -- float32 (tests only): a plain CUDA-core implicit GEMM --

// The same parts, layouts, stride and parities (up: grid z) as the bf16
// body; parts, then taps, then 32-channel chunks, into one accumulator.
__global__ void __launch_bounds__(THREADS)
affine_conv3x3_f32(const Part<float> p0, const Part<float> p1, const float* __restrict__ bias,
                   float* __restrict__ y, int N, int H, int W, int Wp, int Wp2, int D, int mode,
                   int S, int up) {
  using T = float;
  __shared__ __align__(128) T As[BM][Lds<T>::A];
  __shared__ __align__(128) T Bs[BK][Lds<T>::B];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int OH = H / S, OW = W / S;
  const long M = (long)N * OH * OW;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int pad = Wp > 0, XH = pad ? H + 2 : H, XW = pad ? Wp : W;
  const int par = blockIdx.z, pi = par >> 1, pj = par & 1;
  const int OHy = up ? 2 * OH : OH, OWy = up ? 2 * OW : OW;
  const int YH = pad ? OHy + 2 : OHy, YW = pad ? Wp2 : OWy;

  // each thread gathers the same two output rows for the whole K loop
  constexpr int SLOTS = (BM * BK) / (THREADS * 8);
  int rrow[SLOTS], rcg[SLOTS], rn[SLOTS], rh[SLOTS], rw[SLOTS];
  bool rvalid[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    int idx = tid + s * THREADS;
    rrow[s] = idx / (BK / 8);
    rcg[s] = (idx % (BK / 8)) * 8;
    long m = m0 + rrow[s];
    rvalid[s] = m < M;
    long mm = rvalid[s] ? m : 0;
    rn[s] = (int)(mm / ((long)OH * OW));
    int rem = (int)(mm % ((long)OH * OW));
    rh[s] = rem / OW;
    rw[s] = rem % OW;
  }

  Accum<T> acc;
  acc.zero();
  for (int part = 0; part < 2; ++part) {
    const Part<T> q = part ? p1 : p0;
    for (int tap = 0; tap < (up ? 4 : 9) && q.C; ++tap) {
      // up: tap (a, b) of parity (p, p') at offset (p + a - 1, p' + b - 1),
      // row block par * 4 + tap of w16
      const int di = up ? pi + (tap >> 1) - 1 : tap / 3 - 1;
      const int dj = up ? pj + (tap & 1) - 1 : tap % 3 - 1;
      const long wrow = (long)(up ? par * 4 + tap : tap) * q.C;
      for (int c0 = 0; c0 < q.C; c0 += BK) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int hh = S * rh[s] + di, ww = S * rw[s] + dj;
          T* dst = &As[rrow[s]][rcg[s]];
          if (!rvalid[s] || hh < 0 || hh >= H || ww < 0 || ww >= W) {
            zero8(dst);  // the halo is zero after the activation
            continue;
          }
          const long off =
              (((long)rn[s] * XH + hh + pad) * XW + ww + pad) * q.C + c0 + rcg[s];
          if (mode == 0) {
            copy8(dst, q.x + off);
            continue;
          }
          float v[8];
          load8(q.x + off, v);
          const long aoff = (long)rn[s] * q.C + c0 + rcg[s];
          affine8(v, q.a + aoff, q.b + aoff, mode == 2);
          store8(dst, v);
        }
        load_b_tile<T>(Bs, q.w, wrow + c0, D, n0);
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
    const long m = m0 + r;
    if (m >= M) continue;
    const long n = m / ((long)OH * OW);
    const int rem = (int)(m % ((long)OH * OW));
    const int i = up ? 2 * (rem / OW) + pi : rem / OW, j = up ? 2 * (rem % OW) + pj : rem % OW;
    const long o = ((n * YH + i + pad) * YW + j + pad) * D + n0 + c;
    y[o] = Cs[r][c] + bias[n0 + c];
    if (pad) zero_pad_cols(y, o, j, OWy, Wp2, D);
  }
}

cudaError_t launch_f32(const Part<float>* p, const void* bias, void* y, int N, int H, int W,
                       int Wp, int Wp2, int D, int mode, int S, int up, cudaStream_t stream) {
  const long M = (long)N * (H / S) * (W / S);
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(D / BN), up ? 4 : 1);
  affine_conv3x3_f32<<<grid, THREADS, 0, stream>>>(p[0], p[1], static_cast<const float*>(bias),
                                                   static_cast<float*>(y), N, H, W, Wp, Wp2, D,
                                                   mode, S, up);
  return cudaGetLastError();
}

// every entry: two parts from {x0, a0, b0, w0, x1, a1, b1, w1}; up: K5's
// parity tap sets (one part at stride 1)
int launch(const void* const* pa, const int* C, const void* bias, void* y, int N, int H, int W,
           int Wp, int Wp2, int D, int mode, int S, int up, int P, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Part<float> p[2];
    parts_from(pa, C, p);
    return (int)launch_f32(p, bias, y, N, H, W, Wp, Wp2, D, mode, S, up, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  Part<bf16> p[2];
  parts_from(pa, C, p);
  if (up) return (int)dispatch_bf16<1, true>(p, bias, y, N, H, W, Wp, Wp2, D, mode, P, s);
  if (S == 2) return (int)dispatch_bf16<2, false>(p, bias, y, N, H, W, Wp, Wp2, D, mode, P, s);
  return (int)dispatch_bf16<1, false>(p, bias, y, N, H, W, Wp, Wp2, D, mode, P, s);
}

}  // namespace
}  // namespace v2a

// K1. dtype: 0 = float32, 1 = bfloat16. mode: 0 plain conv, 1 affine, 2
// affine+SiLU (a, b null in mode 0). P: pixels per tile of the bf16 body
// (128, 64, 32 or 16, from `affine_conv_plan`; float32 ignores it). Needs
// C % 32 == 0, D % 64 == 0, 16-byte aligned contiguous buffers.
extern "C" int v2a_affine_conv3x3(const void* x, const void* a, const void* b, const void* w,
                                  const void* bias, void* y, int N, int H, int W, int C, int D,
                                  int mode, int P, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || D <= 0 || C % 32 || D % 64 || mode < 0 ||
      mode > 2 || (mode && (!a || !b)))
    return (int)cudaErrorInvalidValue;
  const void* pa[8] = {x, a, b, w, nullptr, nullptr, nullptr, nullptr};
  const int Cs[2] = {C, 0};
  return v2a::launch(pa, Cs, bias, y, N, H, W, 0, 0, D, mode, 1, 0, P, dtype, stream);
}

// K10: K1 in mode 0. x (N, H, W, C), w (9 C, D) tap-major, bias (D)
// float32, y (N, H, W, D); P from `affine_conv_plan(N, H, W, C, D)`.
extern "C" int v2a_spatial_conv3x3(const void* x, const void* w, const void* bias, void* y,
                                   int N, int H, int W, int C, int D, int P, int dtype,
                                   void* stream) {
  return v2a_affine_conv3x3(x, nullptr, nullptr, w, bias, y, N, H, W, C, D, 0, P, dtype, stream);
}

// K4a. dtype as K1's. Part i: x_i (N, H+2, Wp, C_i), a_i / b_i (N, C_i)
// float32, w_i (9 C_i, D); C1 = 0 (and null pointers) for one part. silu:
// mode 2, else 1. P: pixels per tile, from `affine_conv_plan(N, H, W,
// C0 + C1, D)`. Needs C_i % 32 == 0, D % 64 == 0, Wp % 8 == 0, Wp >= W + 2,
// 16-byte aligned contiguous buffers.
extern "C" int v2a_affine_conv3x3_padded(const void* x0, const void* a0, const void* b0,
                                         const void* w0, const void* x1, const void* a1,
                                         const void* b1, const void* w1, const void* bias,
                                         void* y, int N, int H, int W, int Wp, int C0, int C1,
                                         int D, int silu, int P, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C0 <= 0 || C0 % 32 || C1 < 0 || C1 % 32 || D <= 0 ||
      D % 64 || Wp % 8 || Wp < W + 2 || !a0 || !b0 || (C1 && (!x1 || !a1 || !b1 || !w1)))
    return (int)cudaErrorInvalidValue;
  const void* pa[8] = {x0, a0, b0, w0, x1, a1, b1, w1};
  const int Cs[2] = {C0, C1};
  return v2a::launch(pa, Cs, bias, y, N, H, W, Wp, Wp, D, silu ? 2 : 1, 1, 0, P, dtype, stream);
}

// K8. dtype and mode as K1's. x (N, H+2, Wp, C) at the full size, w (9 C,
// D), y (N, H/2+2, Wp2, D). P: pixels per tile, from `affine_conv_plan(N,
// H, W, C, D, stride=2)`. Needs even H and W, C % 32 == 0, D % 64 == 0,
// Wp % 8 == 0, Wp >= W + 2, Wp2 % 8 == 0, Wp2 >= W/2 + 2, 16-byte aligned
// contiguous buffers.
extern "C" int v2a_downconv3x3_padded(const void* x, const void* a, const void* b, const void* w,
                                      const void* bias, void* y, int N, int H, int W, int Wp,
                                      int Wp2, int C, int D, int mode, int P, int dtype,
                                      void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || C <= 0 || C % 32 || D <= 0 || D % 64 ||
      Wp % 8 || Wp < W + 2 || Wp2 % 8 || Wp2 < W / 2 + 2 || mode < 0 || mode > 2 ||
      (mode && (!a || !b)))
    return (int)cudaErrorInvalidValue;
  const void* pa[8] = {x, a, b, w, nullptr, nullptr, nullptr, nullptr};
  const int Cs[2] = {C, 0};
  return v2a::launch(pa, Cs, bias, y, N, H, W, Wp, Wp2, D, mode, 2, 0, P, dtype, stream);
}

// K5. dtype and mode as K1's. x (N, H+2, Wp, C) at the low resolution;
// w16 (16 C, D), row block (p * 2 + p') * 4 + a * 2 + b: the collapsed
// weights of `upconv_weights`, in x's dtype; y (N, 2H+2, Wph, D). P: pixels
// per tile of the low-res grid, from `affine_conv_plan(N, H, W, C, D,
// up=True)`. Needs C % 32 == 0, D % 64 == 0, Wp % 8 == 0, Wp >= W + 2,
// Wph % 8 == 0, Wph >= 2W + 2, 16-byte aligned contiguous buffers.
extern "C" int v2a_upconv3x3_padded(const void* x, const void* a, const void* b, const void* w16,
                                    const void* bias, void* y, int N, int H, int W, int Wp,
                                    int Wph, int C, int D, int mode, int P, int dtype,
                                    void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 32 || D <= 0 || D % 64 || Wp % 8 ||
      Wp < W + 2 || Wph % 8 || Wph < 2 * W + 2 || mode < 0 || mode > 2 || (mode && (!a || !b)))
    return (int)cudaErrorInvalidValue;
  const void* pa[8] = {x, a, b, w16, nullptr, nullptr, nullptr, nullptr};
  const int Cs[2] = {C, 0};
  return v2a::launch(pa, Cs, bias, y, N, H, W, Wp, Wph, D, mode, 1, 1, P, dtype, stream);
}
