// The conv mainloop that K3 (conv_tconv_padded.cu), K12
// (conv_tconv_stream.cu) and K13 (conv_tconv_dma.cu) share: a padded-stream
// PseudoConv3d, the parts' affine(+SiLU) 3x3 conv rounded to bf16 and then
// the 3-tap temporal conv, for one tile of P interior pixels of one sample
// and one cluster rank's slice of NC output channels. The primitives
// (cp.async, TMA, ldmatrix, mma.sync, `row64`, `tile_of`) are hopper.cuh's.
//
// What bounds both on the H100: operations (PERF.md: 6.99 ms of bound per
// B=8 forward for K3's 16 calls, 7.89 for K12's 19). What this design does
// about it, against the wmma kernels it replaced:
//
// - The activation once per element. Per frame and 32-channel chunk, the
//   tile's raw padded window (its 8 x 8 pixels with their one-pixel halo)
//   and the chunk's a, b are copied by cp.async into a 3-stage ring;
//   affine8's arithmetic (no FMA, t * (1 / (1 + e^-t))) runs once per
//   element there, in place, spread over the three steps of the chunk
//   before it, and rounds to bf16. Window positions outside the interior
//   (pad rows that may hold NaN, pad cols, rows past the image; cp.async
//   loads none of them, TMA's box brings them) are written as zero by
//   selection while staging. The nine
//   taps read the one window through ldmatrix at shifted row addresses
//   (any pixel shift is a 64-byte row).
// - Tensor-core tiles fed asynchronously. mma.sync m16n8k16 (bf16 in,
//   float32 sums) by eight warps, A and B by ldmatrix from XOR-swizzled
//   shared memory (no bank conflicts); a pipeline step is three 32-deep
//   products (one tap row, or three temporal taps) with its three weight
//   slabs copied through a 3-stage ring, one barrier a step. The copies
//   follow the copy policy (`Copy`): cp.async by every thread (K3, K12),
//   or TMA (K13), one thread issuing each window as a 4-D box (64-byte
//   swizzle, which is `row64`) with its a, b as bulk copies and each weight
//   slab as 2-D boxes of 64 columns (128-byte swizzle: a slab is stored as
//   64-column halves of 128-byte rows for both policies), each ring stage
//   completing on its own mbarrier. The products and their order do not
//   depend on the policy, so K13 is bit-equal to K3. (`wgmma` with
//   warp-specialised producers is the next step.)
// - Full 64-row tiles through a cluster along D. The tile's rounded conv
//   output (K3: every frame; K12: a 3-frame ring) is split over a cluster
//   of D / NC CTAs (NC = 128, or 64 where 128 does not divide D), each
//   holding NC channels: 7 x 64 x 128 x 2 = 112 KiB at F = 7 where one CTA
//   with all of D = 384 would need 336 KiB. The temporal GEMM (K = 3 D)
//   reads its own slice straight from its slots and the other ranks'
//   slices through distributed shared memory, staged into local tiles a
//   step ahead; cluster barriers order the conv halves before the reads
//   and the reads before any overwrite or exit. The epilogue loads its
//   residual pairs before its first store and keeps the per-column biases
//   in registers.
// - The tile plan (`conv_tconv_plan` in ops/resblock_kernels.py) picks P in
//   {64, 32, 16}: the largest whose shared memory fits and whose grid has a
//   CTA per SM, so a B = 1 request fills the card too.
//
// What stays: the conv output is rounded to bf16 (kbias added first)
// before the temporal taps; a missing temporal neighbour is selected to
// zero; K3's skip fold (further K steps of the same accumulator) and sbias;
// emb and the residual read at interior positions only; y's pad cols
// exactly zero and its pad rows unwritten; statistics as fixed-order
// per-tile float32 column sums of the rounded y, added by `reduce_tiles`,
// so two launches are bit-equal. An optional conv_out receives the
// kernel's own rounded conv half (null on the model's path).
//
// float32 (tests only) takes two plain CUDA-core passes: the conv into
// conv_out, then the temporal conv out of it.
#pragma once

#include <cooperative_groups.h>
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

namespace v2a {
namespace hop {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;   // eight warps
constexpr int KSTEP = 32;      // channels per sub-step (a 32-deep product)
constexpr int SUBS = 3;        // sub-steps per pipeline step: 3 taps, or 3 channel chunks
constexpr int STAGES = 3;      // weight-slab ring, SUBS slabs a stage
constexpr int WSTAGES = 3;     // window ring
constexpr int MAX_SMEM = 232448;
constexpr int MAX_CLUSTER = 8;

template <typename T>
struct Args {
  Part<T> p[2];
  Skip<T> q[2];
  const float* kbias;
  const T* tw;  // (3 D, D)
  const float* tbias;
  const float* emb;  // (B, D) or null
  const T* res;      // like y, or null
  const float* sbias;
  T* y;
  T* conv_out;  // (B, F, Hp, Wp, D) interior, or null
  float* partial;
  int B, F, H, W, Wp, D, silu;
};

inline int slice_of(int D) { return D % 128 == 0 ? 128 : 64; }

// How the window and weight-slab copies are issued: cp.async by every
// thread into commit groups (K3, K12), or TMA by one thread, each ring
// stage completing on its own mbarrier (K13). The products, their order
// and the shared-memory layout they read are the same.
enum class Copy { cp_async, tma };

// K13's tensor maps: each part's padded stream (C, Wp, Hp, B*F) in boxes of
// one window (32 channels, 64-byte swizzle: `row64`), each part's (9 C, D)
// weights, the (3 D, D) temporal weights and each skip part's (Cs, D)
// projection in boxes of 32 rows x 64 columns (128-byte swizzle); absent
// parts' maps unused
struct Maps {
  CUtensorMap x[2], w[2], tw, k[2];
};

// shared memory: [slots][P][NC] conv output, [STAGES][SUBS] weight slabs
// of [NC / 64][KSTEP][64] (128-byte rows, chunks ^ (row & 7)), [WSTAGES]
// windows of (th+2)(tw+2) 64-byte rows with the chunk's 32 a and 32 b
// (aliased by the [2][SUBS][P] temporal A tiles), [WM][2][NC] float32
// statistics; TMA: its swizzles need 1024-byte-aligned slabs and 512-byte
// windows, and 6 mbarriers follow
constexpr int HALF = KSTEP * 128;  // bytes of one 64-column half of a weight slab
__host__ __device__ inline int window_bytes(const Tile& t, Copy cp) {
  const int b = (t.th + 2) * (t.tw + 2) * KSTEP * 2 + 2 * KSTEP * 4;
  return cp == Copy::tma ? (b + 511) / 512 * 512 : b;
}
inline int ring_bytes(const Tile& t, int P, Copy cp) {
  const int w = WSTAGES * window_bytes(t, cp), a = 2 * SUBS * P * KSTEP * 2;
  return w > a ? w : a;
}
inline size_t smem_bytes(int P, int NC, const Tile& t, int slots, Copy cp) {
  const int wm = P >= 32 ? 2 : 1;
  return (size_t)slots * P * NC * 2 + (size_t)STAGES * SUBS * KSTEP * NC * 2 +
         ring_bytes(t, P, cp) + (size_t)wm * 2 * NC * 4 +
         (cp == Copy::tma ? 1024 + 8 * (STAGES + WSTAGES) : 0);
}

// One CTA's state: tile, cluster rank, shared memory and accumulators.
// CP: how its copies are issued (`Copy`); TMA takes the kernel's `Maps`.
template <int P, int NC, Copy CP = Copy::cp_async>
struct Mainloop {
  static constexpr int WM = P >= 32 ? 2 : 1, WN = THREADS / 32 / WM;  // warps over rows, cols
  static constexpr int MT = P / 16 / WM, NT = NC / 8 / WN;  // m16 and n8 tiles a warp
  static constexpr int RB = NC * 2;                         // bytes per conv row
  static constexpr int SLAB = KSTEP * RB;                   // bytes per 32-row weight slab
  static constexpr int CPR = NC / KSTEP;                    // 32-channel chunks a rank holds
  static constexpr int AT = P * 64;                         // bytes per temporal A tile
  static constexpr int VPT = (SUBS * P * 4 + THREADS - 1) / THREADS;  // A vectors a thread

  const Args<bf16>& A;
  const Maps* mp;  // TMA's maps, or null
  cg::cluster_group cl;
  unsigned char* ys;   // [slots][P][NC] conv output, rounded, row chunks ^ (row & 7)
  unsigned char* win;  // window ring / temporal A tiles
  float* red;          // [WM][2][NC]
  uint32_t y_s, b_s, w_s;  // conv slots, weight ring, window ring (shared addresses)
  uint32_t bar_s;          // TMA: [WSTAGES] window and [STAGES] weight-stage mbarriers
  uint32_t wph = 0, bph = 0;  // TMA: parity of each window / weight stage's next phase
  int wbytes, R, R4;
  int nch0, nch, Hp;
  int b, tile, rank, n0, h0, w0, tiles;
  Tile t;
  int tid, lane, wm, wn;
  int arow[MT];  // this lane's ldmatrix row of each m16 tile
  int apix[MT];  // its window pixel at tap (0, 0)
  float acc[MT][NT][4];
  // per column this thread owns (n8 tile nt, pair j): kbias, tbias [+ emb of
  // the sample], sbias; read once per CTA
  float kb[NT][2], off[NT][2], sbv[NT][2];

  __device__ Mainloop(const Args<bf16>& args, unsigned char* smem, int slots,
                      const Maps* maps = nullptr)
      : A(args), mp(maps), cl(cg::this_cluster()) {
    tid = threadIdx.x;
    lane = tid & 31;
    wm = (tid >> 5) / WN;
    wn = (tid >> 5) % WN;
    Hp = A.H + 2;
    nch0 = A.p[0].C / KSTEP;
    nch = nch0 + A.p[1].C / KSTEP;
    t = tile_of(A.H, A.W, P);
    tiles = t.tiles;
    R = (t.th + 2) * (t.tw + 2);
    R4 = R * 4;
    wbytes = window_bytes(t, CP);
    const int cid = blockIdx.x / (int)cl.num_blocks();
    b = cid / t.tiles;
    tile = cid % t.tiles;
    h0 = (tile / t.tiles_w) * t.th;
    w0 = (tile % t.tiles_w) * t.tw;
    rank = (int)cl.block_rank();
    n0 = rank * NC;
    if constexpr (CP == Copy::tma) smem += (1024 - (smem_u32(smem) & 1023)) & 1023;
    ys = smem;
    unsigned char* bring = ys + (size_t)slots * P * RB;
    win = bring + STAGES * SUBS * SLAB;
    const int wr = WSTAGES * wbytes > 2 * SUBS * AT ? WSTAGES * wbytes : 2 * SUBS * AT;
    red = reinterpret_cast<float*>(win + wr);
    y_s = smem_u32(ys);
    b_s = smem_u32(bring);
    w_s = smem_u32(win);
    bar_s = smem_u32(red + WM * 2 * NC);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = wm * (P / WM) + mt * 16 + (lane & 15);
      arow[mt] = m;
      apix[mt] = m < t.th * t.tw ? (m / t.tw) * (t.tw + 2) + m % t.tw : 0;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = n0 + wn * (NC / WN) + nt * 8 + (lane & 3) * 2 + j;
        kb[nt][j] = A.kbias[e];
        float o = A.tbias[e];
        if (A.emb) o += A.emb[(long)b * A.D + e];
        off[nt][j] = o;
        sbv[nt][j] = A.sbias ? A.sbias[e] : 0.f;
      }
    if constexpr (CP == Copy::tma) {
      if (tid == 0) {
        for (int i = 0; i < WSTAGES + STAGES; ++i) mbar_init(bar_s + 8 * i, 1);
        fence_mbar_init();
      }
      __syncthreads();
    }
  }

  // -- the copy policy: the barrier of a pipeline step, and the end of a phase --

  __device__ __forceinline__ uint32_t wbar(int ws) const { return bar_s + 8 * ws; }
  __device__ __forceinline__ uint32_t bbar(int st) const { return bar_s + 8 * (WSTAGES + st); }
  // TMA: waits for the next phase of window stage ws
  __device__ __forceinline__ void wait_window(int ws) {
    mbar_wait(wbar(ws), (wph >> ws) & 1);
    wph ^= 1u << ws;
  }
  __device__ __forceinline__ void commit() {
    if constexpr (CP == Copy::cp_async) cp_commit();
  }
  // the top of pipeline step j: its weight stage landed (and, TMA, window
  // stage `ws` where ws >= 0; cp.async lands every window a chunk before
  // it is activated), then one CTA barrier, after which the stage the last
  // step read may be overwritten
  __device__ __forceinline__ void step_barrier(int stage, int ws) {
    if constexpr (CP == Copy::cp_async) {
      cp_wait<STAGES - 2>();
    } else {
      mbar_wait(bbar(stage), (bph >> stage) & 1);
      bph ^= 1u << stage;
      if (ws >= 0) wait_window(ws);
      fence_proxy_async();  // this thread's writes to a ring stage before TMA refills it
    }
    __syncthreads();
  }
  __device__ __forceinline__ void phase_end() {
    if constexpr (CP == Copy::cp_async) cp_wait<0>();
    else fence_proxy_async();
    __syncthreads();
  }

  __device__ void zero() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  }

  // interior (h, w) of tile row m, or false past the tile or the image
  __device__ bool pixel(int m, int& h, int& w) const {
    h = h0 + m / t.tw;
    w = w0 + m % t.tw;
    return m < t.th * t.tw && h < A.H && w < A.W;
  }

  // `nsub` slabs of KSTEP rows of a row-major (K, D) matrix w (TMA: its
  // map), slab s from row row0 + s * step, columns n0 .. n0 + NC, into
  // weight stage `stage`: 64-column halves of 128-byte rows, chunks ^ (k & 7)
  __device__ void issue_b(const CUtensorMap* map, const bf16* w, long row0, long step, int nsub,
                          int stage) {
    const uint32_t base = b_s + stage * (SUBS * SLAB);
    if constexpr (CP == Copy::tma) {
      if (tid == 0) {
        mbar_expect(bbar(stage), nsub * SLAB);
        for (int s = 0; s < nsub; ++s)
          for (int h = 0; h < NC / 64; ++h)
            tma_load_2d(base + s * SLAB + h * HALF, map, n0 + 64 * h, (int)(row0 + s * step),
                        bbar(stage));
      }
    } else {
      for (int v = tid; v < nsub * KSTEP * (NC / 8); v += THREADS) {
        const int s = v / (KSTEP * (NC / 8)), r = v % (KSTEP * (NC / 8));
        const int k = r / (NC / 8), ch = r % (NC / 8);
        cp_async16(base + s * SLAB + (ch >> 3) * HALF + k * 128 + (((ch & 7) ^ (k & 7)) << 4),
                   w + (row0 + s * step + k) * A.D + n0 + ch * 8);
      }
    }
  }

  // B fragments of k16 step kk of slab `bb`, the products with a
  __device__ __forceinline__ void mma_b(uint32_t bb, int kk, const uint32_t (&a)[MT][4]) {
    mma_slab<MT, NT>(acc, bb, kk, a, wn * (NC / WN), lane);
  }

  // -- the conv half: a step is (chunk g, tap row di), its sub-steps the
  // three taps (di, dj) --

  // the part of channel chunk k (returned), and the chunk's first channel
  __device__ int chunk_of(int k, const Part<bf16>*& Q, int& c0) const {
    Q = k < nch0 ? &A.p[0] : &A.p[1];
    c0 = (k < nch0 ? k : k - nch0) * KSTEP;
    return k < nch0 ? 0 : 1;
  }

  // the raw window of (frame, chunk k) and the chunk's a, b into window
  // stage ws; cp.async loads no position outside the interior, TMA loads
  // the whole box (pad rows and cols too, zero past the stream's end)
  __device__ void issue_window(int frame, int k, int ws) {
    const Part<bf16>* Q;
    int c0;
    const int part = chunk_of(k, Q, c0);
    const long n = (long)b * A.F + frame;
    const uint32_t base = w_s + ws * wbytes;
    if constexpr (CP == Copy::tma) {
      if (tid == 0) {
        mbar_expect(wbar(ws), R * 64 + 2 * KSTEP * 4);
        tma_load_4d(base, &mp->x[part], c0, w0, h0, (int)n, wbar(ws));
        bulk_load(base + R * 64, Q->a + n * Q->C + c0, KSTEP * 4, wbar(ws));
        bulk_load(base + R * 64 + KSTEP * 4, Q->b + n * Q->C + c0, KSTEP * 4, wbar(ws));
      }
    } else {
      const int tw2 = t.tw + 2;
      for (int v = tid; v < R4; v += THREADS) {
        const int pix = v >> 2, ch = v & 3;
        const int pr = h0 + pix / tw2, pc = w0 + pix % tw2;  // padded coordinates
        if (pr < 1 || pr > A.H || pc < 1 || pc > A.W) continue;
        cp_async16(base + row64(pix, ch),
                   Q->x + ((n * Hp + pr) * A.Wp + pc) * Q->C + c0 + ch * 8);
      }
      if (tid < 16)
        cp_async16(base + R * 64 + tid * 16,
                   (tid < 8 ? Q->a : Q->b) + n * Q->C + c0 + (tid & 7) * 4);
    }
  }

  // affine8 in place on vectors [lo, hi) of window stage ws, rounded to
  // bf16; every position outside the interior selected to zero
  __device__ void activate(int ws, int lo, int hi) {
    unsigned char* base = win + ws * wbytes;
    const float* ab = reinterpret_cast<const float*>(base + R * 64);  // a[32], b[32]
    const int tw2 = t.tw + 2;
    for (int v = lo + tid; v < hi; v += THREADS) {
      const int pix = v >> 2, ch = v & 3;
      const int pr = h0 + pix / tw2, pc = w0 + pix % tw2;
      bf16* p = reinterpret_cast<bf16*>(base + row64(pix, ch));
      if (pr < 1 || pr > A.H || pc < 1 || pc > A.W) {
        zero8(p);
        continue;
      }
      float x[8];
      load8(p, x);
      affine8(x, ab + ch * 8, ab + KSTEP + ch * 8, A.silu);
      store8(p, x);
    }
  }

  // the three taps of tap row di: A rows are the window shifted by each tap
  __device__ __forceinline__ void mma_taps(int ws, int stage, int di) {
    const uint32_t wb = w_s + ws * wbytes, bb = b_s + stage * (SUBS * SLAB);
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int off = di * (t.tw + 2) + dj;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(wb + row64(apix[mt] + off, 2 * kk + (lane >> 4)), a[mt]);
        mma_b(bb + dj * SLAB, kk, a);
      }
    }
  }

  // the conv output of one frame: + kbias, rounded, into slot `slot` (and
  // conv_out's interior when asked)
  __device__ void store_conv(int slot, int frame) {
    unsigned char* s = ys + (size_t)slot * P * RB;
    const long n = (long)b * A.F + frame;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = wm * (P / WM) + mt * 16 + (lane >> 2) + hh * 8;
        int h, w;
        const bool ok = pixel(m, h, w);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = wn * (NC / WN) + nt * 8 + (lane & 3) * 2;
          const __nv_bfloat162 r = __floats2bfloat162_rn(acc[mt][nt][2 * hh] + kb[nt][0],
                                                         acc[mt][nt][2 * hh + 1] + kb[nt][1]);
          *reinterpret_cast<__nv_bfloat162*>(s + m * RB + (((col >> 3) ^ (m & 7)) << 4) +
                                             (col & 7) * 2) = r;
          if (A.conv_out && ok)
            *reinterpret_cast<__nv_bfloat162*>(
                A.conv_out + ((n * Hp + h + 1) * A.Wp + w + 1) * A.D + n0 + col) = r;
        }
      }
  }

  // the conv of frames [f0, f0 + nf) into slots (ring ? f % ring : f)
  __device__ void conv_frames(int f0, int nf, int ring) {
    const int nchunk = nf * nch, nsteps = nchunk * 3;
    auto issue_w = [&](int g) { issue_window(f0 + g / nch, g % nch, g % WSTAGES); };
    auto issue_bs = [&](int j) {
      const Part<bf16>* Q;
      int c0;
      const int part = chunk_of((j / 3) % nch, Q, c0);
      issue_b(mp ? &mp->w[part] : nullptr, Q->w, (long)(j % 3) * 3 * Q->C + c0, Q->C, 3,
              j % STAGES);
    };
    issue_w(0);
    if (nchunk > 1) issue_w(1);
    issue_bs(0);
    commit();
    for (int s = 1; s < STAGES - 1; ++s) {
      if (s < nsteps) issue_bs(s);
      commit();
    }
    if constexpr (CP == Copy::tma) {
      wait_window(0);
    } else {
      cp_wait<STAGES - 2>();
      __syncthreads();
    }
    activate(0, 0, R4);
    zero();
    for (int j = 0; j < nsteps; ++j) {
      const int g = j / 3, di = j % 3;
      step_barrier(j % STAGES, di == 0 && g + 1 < nchunk ? (g + 1) % WSTAGES : -1);
      if (j + STAGES - 1 < nsteps) issue_bs(j + STAGES - 1);
      if (di == 0 && g + 2 < nchunk) issue_w(g + 2);
      commit();
      // the next chunk's window, a third at a time (its raw copy landed a
      // chunk ago)
      if (g + 1 < nchunk) activate((g + 1) % WSTAGES, di * R4 / 3, (di + 1) * R4 / 3);
      mma_taps(g % WSTAGES, j % STAGES, di);
      if (di == 2 && (g + 1) % nch == 0) {
        const int f = f0 + g / nch;
        store_conv(ring ? f % ring : f, f);
        zero();
      }
    }
    phase_end();
  }

  // -- the temporal half: a step is three 32-deep products, the taps
  // t = 0, 1, 2 of one channel chunk of D, or up to three chunks of a skip
  // part --

  // the A tiles of one step into registers: vector v is row (v % 4P) / 4 of
  // sub-step v / 4P. Taps: conv slot `slot[u]` (< 0: a missing frame,
  // zeros) of cluster rank q, its chunk dc. Skip parts: chunks c0 + 32 u of
  // skip part `sq` (nsub of them) at frame `frame`.
  __device__ __forceinline__ void fetch_taps(uint4 r[VPT], const int slot[3], int q, int dc) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = tid + i * THREADS;
      r[i] = make_uint4(0, 0, 0, 0);
      if (v >= SUBS * P * 4) continue;
      const int u = v / (P * 4), row = (v % (P * 4)) >> 2, ch = v & 3;
      const int su = u == 0 ? slot[0] : u == 1 ? slot[1] : slot[2];
      if (su < 0) continue;
      unsigned char* src =
          ys + (size_t)su * P * RB + row * RB + (((dc * 4 + ch) ^ (row & 7)) << 4);
      r[i] = *reinterpret_cast<const uint4*>(cl.map_shared_rank(src, q));
    }
  }
  __device__ __forceinline__ void fetch_skip(uint4 r[VPT], const Skip<bf16>& sq, int c0,
                                             int nsub, int frame) {
    const long n = (long)b * A.F + frame;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = tid + i * THREADS;
      r[i] = make_uint4(0, 0, 0, 0);
      const int u = v / (P * 4), row = (v % (P * 4)) >> 2;
      int h, w;
      if (v >= SUBS * P * 4 || u >= nsub || !pixel(row, h, w)) continue;
      r[i] = *reinterpret_cast<const uint4*>(
          sq.x + ((n * Hp + h + 1) * A.Wp + w + 1) * sq.C + c0 + u * KSTEP + (v & 3) * 8);
    }
  }
  __device__ __forceinline__ void store_staged(int sbuf, const uint4 r[VPT]) {
    unsigned char* base = win + sbuf * (SUBS * AT);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = tid + i * THREADS;
      if (v < SUBS * P * 4)
        *reinterpret_cast<uint4*>(base + (v / (P * 4)) * AT + row64((v % (P * 4)) >> 2, v & 3)) =
            r[i];
    }
  }
  // sub-step u of a staged step: A from temporal A tile u of buffer sbuf
  __device__ __forceinline__ void mma_staged(int sbuf, int stage, int u) {
    const uint32_t sb = w_s + sbuf * (SUBS * AT) + u * AT;
    const uint32_t bb = b_s + stage * (SUBS * SLAB) + u * SLAB;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4(sb + row64(arow[mt], 2 * kk + (lane >> 4)), a[mt]);
      mma_b(bb, kk, a);
    }
  }
  // sub-step u of a tap step whose chunk dc this CTA holds: A straight from
  // its conv slot (rows' chunks ^ (row & 7), as `store_conv` wrote them)
  __device__ __forceinline__ void mma_local(int slot, int dc, int stage, int u) {
    const uint32_t yb = y_s + slot * (P * RB);
    const uint32_t bb = b_s + stage * (SUBS * SLAB) + u * SLAB;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = arow[mt], ch = dc * 4 + 2 * kk + (lane >> 4);
        ldsm_x4(yb + row * RB + ((ch ^ (row & 7)) << 4), a[mt]);
      }
      mma_b(bb, kk, a);
    }
  }

  // the epilogue of output frame g: + tbias [+ emb] [+ sbias] [+ residual],
  // rounded once into y's interior, pad cols zero, and the tile's column
  // sums of the rounded y (fixed order: rows per thread, a shuffle tree,
  // then the row warps in order). The residual pairs are all loaded before
  // the first store (a store to y could alias a later load, which would
  // serialise the loads).
  __device__ void store_out(int g) {
    const long n = (long)b * A.F + g;
    const int D = A.D;
    float2 rv[MT][2][NT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = wm * (P / WM) + mt * 16 + (lane >> 2) + hh * 8;
        int h, w;
        const bool ok = A.res && pixel(m, h, w);
        const long o0 = ((n * Hp + h + 1) * A.Wp + w + 1) * D + n0 + wn * (NC / WN) + (lane & 3) * 2;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          rv[mt][hh][nt] = ok ? __bfloat1622float2(
                                    *reinterpret_cast<const __nv_bfloat162*>(A.res + o0 + nt * 8))
                              : make_float2(0.f, 0.f);
      }
    float s[NT][2][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[nt][j][0] = s[nt][j][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = wm * (P / WM) + mt * 16 + (lane >> 2) + hh * 8;
        int h, w;
        if (!pixel(m, h, w)) continue;
        const long o0 = ((n * Hp + h + 1) * A.Wp + w + 1) * D;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int e = n0 + wn * (NC / WN) + nt * 8 + (lane & 3) * 2;
          const long o = o0 + e;
          float v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            v[j] = acc[mt][nt][2 * hh + j] + off[nt][j];
            if (A.sbias) v[j] += sbv[nt][j];
          }
          if (A.res) {
            v[0] += rv[mt][hh][nt].x;
            v[1] += rv[mt][hh][nt].y;
          }
          const __nv_bfloat162 r = __floats2bfloat162_rn(v[0], v[1]);
          *reinterpret_cast<__nv_bfloat162*>(A.y + o) = r;
          const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
          if (w == 0) *reinterpret_cast<__nv_bfloat162*>(A.y + o - D) = z;
          if (w == A.W - 1)
            for (int k = 1; k < A.Wp - A.W; ++k)
              *reinterpret_cast<__nv_bfloat162*>(A.y + o + (long)k * D) = z;
          const float2 q = __bfloat1622float2(r);
          s[nt][0][0] += q.x;
          s[nt][0][1] += q.x * q.x;
          s[nt][1][0] += q.y;
          s[nt][1][1] += q.y * q.y;
        }
      }
    if (!A.partial) return;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int which = 0; which < 2; ++which)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            s[nt][j][which] += __shfl_xor_sync(0xffffffffu, s[nt][j][which], o);
    if (lane < 4) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = wn * (NC / WN) + nt * 8 + lane * 2 + j;
          red[(wm * 2) * NC + col] = s[nt][j][0];
          red[(wm * 2 + 1) * NC + col] = s[nt][j][1];
        }
    }
    __syncthreads();
    for (int i = tid; i < 2 * NC; i += THREADS) {
      const int which = i / NC, col = i % NC;
      float v = 0.f;
      for (int r = 0; r < WM; ++r) v += red[(r * 2 + which) * NC + col];
      A.partial[((n * tiles + tile) * 2 + which) * D + n0 + col] = v;
    }
    // red is written again only after further loop barriers
  }

  // the temporal taps (and K3's skip parts) of frames [g0, g0 + ng) out of
  // the cluster's conv slots (ring ? f % ring : f). A tap step whose chunk
  // this CTA holds reads its slots directly; one held by another rank, or a
  // skip step, is staged through registers into a local A tile one step
  // ahead. A missing temporal neighbour's product is left out (its A is
  // zero).
  __device__ void tconv_frames(int g0, int ng, int ring) {
    const int D = A.D, dch = D / KSTEP;
    const int sk0 = A.q[0].C / KSTEP, sk1 = A.q[1].C / KSTEP;
    const int ss0 = (sk0 + SUBS - 1) / SUBS, ss1 = (sk1 + SUBS - 1) / SUBS;
    const int mid = dch + ss0 + ss1, nsteps = ng * mid;
    // skip step s of a frame: part, first chunk, chunks
    auto skip_of = [&](int s, int& part, int& c, int& nsub) {
      part = s < ss0 ? 0 : 1;
      const int i = part ? s - ss0 : s, n = part ? sk1 : sk0;
      c = i * SUBS;
      nsub = n - c < SUBS ? n - c : SUBS;
    };
    auto slot_of = [&](int g, int u) {
      const int ff = g + u - 1;
      return ff < 0 || ff >= A.F ? -1 : (ring ? ff % ring : ff);
    };
    auto local = [&](int j) {
      const int r = j % mid;
      return r < dch && r / CPR == rank;
    };
    auto issue_bs = [&](int j) {
      const int r = j % mid;
      if (r < dch) {
        issue_b(mp ? &mp->tw : nullptr, A.tw, (long)r * KSTEP, D, SUBS, j % STAGES);
      } else {
        int part, c, ns;
        skip_of(r - dch, part, c, ns);
        issue_b(mp ? &mp->k[part] : nullptr, A.q[part].k, (long)c * KSTEP, KSTEP, ns,
                j % STAGES);
      }
    };
    auto fetch = [&](int j, uint4 r[VPT]) {
      const int g = g0 + j / mid, rr = j % mid;
      if (rr < dch) {
        const int slot[3] = {slot_of(g, 0), slot_of(g, 1), slot_of(g, 2)};
        fetch_taps(r, slot, rr / CPR, rr % CPR);
      } else {
        int part, c, ns;
        skip_of(rr - dch, part, c, ns);
        fetch_skip(r, A.q[part], c * KSTEP, ns, g);
      }
    };
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nsteps) issue_bs(s);
      commit();
    }
    uint4 r[VPT];
    if (!local(0)) {
      fetch(0, r);
      store_staged(0, r);
    }
    zero();
    for (int j = 0; j < nsteps; ++j) {
      step_barrier(j % STAGES, -1);
      if (j + STAGES - 1 < nsteps) issue_bs(j + STAGES - 1);
      commit();
      const bool stage_next = j + 1 < nsteps && !local(j + 1);
      if (stage_next) fetch(j + 1, r);
      const int g = g0 + j / mid, rr = j % mid, stage = j % STAGES;
      if (rr < dch) {
        const bool mine = rr / CPR == rank;
#pragma unroll
        for (int u = 0; u < SUBS; ++u) {
          const int slot = slot_of(g, u);
          if (slot < 0) continue;
          if (mine)
            mma_local(slot, rr % CPR, stage, u);
          else
            mma_staged(j & 1, stage, u);
        }
      } else {
        int part, c, ns;
        skip_of(rr - dch, part, c, ns);
#pragma unroll
        for (int u = 0; u < SUBS; ++u)
          if (u < ns) mma_staged(j & 1, stage, u);
      }
      if (stage_next) store_staged((j + 1) & 1, r);
      if ((j + 1) % mid == 0) {
        store_out(g0 + j / mid);
        zero();
      }
    }
    phase_end();
  }
};

// -- float32: two plain CUDA-core passes (tests only) --

// conv_out's interior = sum_parts conv3x3(act(x)) + kbias, one thread per
// output element, the taps in (part, tap, channel) order
__global__ void conv_f32_kernel(Args<float> a) {
  const int S = a.H * a.W, Hp = a.H + 2;
  const long total = (long)a.B * a.F * S * a.D;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int d = (int)(i % a.D);
    const int pix = (int)((i / a.D) % S);
    const long n = i / ((long)a.D * S);
    const int h = pix / a.W, w = pix % a.W;
    float sum = 0.f;
    for (int part = 0; part < 2; ++part) {
      const Part<float>& Q = a.p[part];
      for (int tap = 0; tap < 9 && Q.C; ++tap) {
        const int pr = h + tap / 3, pc = w + tap % 3;  // padded coordinates
        if (pr < 1 || pr > a.H || pc < 1 || pc > a.W) continue;
        const float* x = Q.x + ((n * Hp + pr) * a.Wp + pc) * Q.C;
        for (int c = 0; c < Q.C; ++c) {
          float t = __fadd_rn(__fmul_rn(x[c], Q.a[n * Q.C + c]), Q.b[n * Q.C + c]);
          if (a.silu) t = __fmul_rn(t, 1.f / (1.f + expf(-t)));
          sum += t * Q.w[((long)tap * Q.C + c) * a.D + d];
        }
      }
    }
    a.conv_out[((n * Hp + h + 1) * a.Wp + w + 1) * a.D + d] = sum + a.kbias[d];
  }
}

// y out of conv_out: block (sample-frame, tile), a thread per column,
// the tile's rows in order (its column sums in that order)
__global__ void tconv_f32_kernel(Args<float> a, int P) {
  const Tile t = tile_of(a.H, a.W, P);
  const long n = blockIdx.x / t.tiles;
  const int tile = blockIdx.x % t.tiles;
  const int bb = (int)(n / a.F), g = (int)(n % a.F), Hp = a.H + 2, D = a.D;
  const int h0 = (tile / t.tiles_w) * t.th, w0 = (tile % t.tiles_w) * t.tw;
  for (int e = threadIdx.x; e < D; e += blockDim.x) {
    float s = 0.f, ss = 0.f;
    for (int m = 0; m < t.th * t.tw; ++m) {
      const int h = h0 + m / t.tw, w = w0 + m % t.tw;
      if (h >= a.H || w >= a.W) continue;
      auto pos = [&](int f) { return (((long)bb * a.F + f) * Hp + h + 1) * a.Wp + w + 1; };
      float acc = 0.f;
      for (int k = 0; k < 3; ++k) {
        const int ff = g + k - 1;
        if (ff < 0 || ff >= a.F) continue;
        const float* yr = a.conv_out + pos(ff) * D;
        for (int d = 0; d < D; ++d) acc += yr[d] * a.tw[((long)k * D + d) * D + e];
      }
      for (int part = 0; part < 2; ++part) {
        const Skip<float>& q = a.q[part];
        for (int c = 0; c < q.C; ++c) acc += q.x[pos(g) * q.C + c] * q.k[(long)c * D + e];
      }
      float off = a.tbias[e];
      if (a.emb) off += a.emb[(long)bb * D + e];
      float v = acc + off;
      if (a.sbias) v += a.sbias[e];
      const long o = pos(g) * D + e;
      if (a.res) v += a.res[o];
      a.y[o] = v;
      zero_pad_cols(a.y, o, w, a.W, a.Wp, D);
      s += v;
      ss += v * v;
    }
    if (a.partial) {
      a.partial[((n * t.tiles + tile) * 2) * D + e] = s;
      a.partial[((n * t.tiles + tile) * 2 + 1) * D + e] = ss;
    }
  }
}

inline cudaError_t launch_f32(const Args<float>& a, int P, float* stats, cudaStream_t stream) {
  const long total = (long)a.B * a.F * a.H * a.W * a.D;
  const long blocks = (total + 255) / 256;
  conv_f32_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Tile t = tile_of(a.H, a.W, P);
  tconv_f32_kernel<<<(unsigned)(a.B * a.F * t.tiles), 128, 0, stream>>>(a, P);
  err = cudaGetLastError();
  if (err != cudaSuccess || !a.partial) return err;
  return reduce_tiles(a.partial, stats, (long)a.B * a.F, a.D, t.tiles, stream);
}

// K13's maps of the tensors in `a`, the window boxes those of tile t
inline int encode_maps(Maps& m, const Args<bf16>& a, const Tile& t) {
  memset(&m, 0, sizeof(m));
  const uint64_t D = a.D, Hp = a.H + 2;
  const uint32_t wbox[4] = {KSTEP, (uint32_t)t.tw + 2, (uint32_t)t.th + 2, 1};
  const uint32_t bbox[2] = {64, KSTEP};
  auto weights = [&](CUtensorMap* map, const bf16* w, uint64_t rows) {
    const uint64_t dims[2] = {D, rows}, strides[1] = {D * 2};
    return encode_tiled(map, w, 2, dims, strides, bbox, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  int bad = weights(&m.tw, a.tw, 3 * D);
  for (int i = 0; i < 2 && !bad; ++i) {
    const Part<bf16>& Q = a.p[i];
    if (Q.C) {
      const uint64_t C = Q.C;
      const uint64_t dims[4] = {C, (uint64_t)a.Wp, Hp, (uint64_t)a.B * a.F};
      const uint64_t strides[3] = {C * 2, C * 2 * a.Wp, C * 2 * a.Wp * Hp};
      bad = encode_tiled(&m.x[i], Q.x, 4, dims, strides, wbox, CU_TENSOR_MAP_SWIZZLE_64B);
      if (!bad) bad = weights(&m.w[i], Q.w, 9 * C);
    }
    if (!bad && a.q[i].C) bad = weights(&m.k[i], a.q[i].k, a.q[i].C);
  }
  return bad;
}

// bf16: one kernel (K::fn<P, NC>, which takes `Maps` too where CP is TMA)
// on a grid of B * tiles * (D / NC) CTAs in clusters of D / NC along D,
// then the statistics pass
template <int P, int NC, Copy CP, class Kern>
cudaError_t launch_one(Kern kernel, const Args<bf16>& a, int slots, float* stats,
                       cudaStream_t stream) {
  const Tile t = tile_of(a.H, a.W, P);
  const size_t smem = smem_bytes(P, NC, t, slots, CP);
  const int cluster = a.D / NC;
  if (smem > (size_t)MAX_SMEM || cluster > MAX_CLUSTER) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.B * t.tiles * cluster), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (CP == Copy::tma) {
    Maps maps;
    if (encode_maps(maps, a, t)) return cudaErrorInvalidValue;
    err = cudaLaunchKernelEx(&cfg, kernel, a, maps);
  } else {
    err = cudaLaunchKernelEx(&cfg, kernel, a);
  }
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || !a.partial) return err;
  return reduce_tiles(a.partial, stats, (long)a.B * a.F, a.D, t.tiles, stream);
}

// K provides `template <int P, int NC> static auto fn()`, its kernel
template <class K, Copy CP = Copy::cp_async>
cudaError_t launch_bf16(const Args<bf16>& a, int P, int slots, float* stats, cudaStream_t s) {
  if (slice_of(a.D) == 128) {
    if (P == 64) return launch_one<64, 128, CP>(K::template fn<64, 128>(), a, slots, stats, s);
    if (P == 32) return launch_one<32, 128, CP>(K::template fn<32, 128>(), a, slots, stats, s);
    if (P == 16) return launch_one<16, 128, CP>(K::template fn<16, 128>(), a, slots, stats, s);
  } else {
    if (P == 64) return launch_one<64, 64, CP>(K::template fn<64, 64>(), a, slots, stats, s);
    if (P == 32) return launch_one<32, 64, CP>(K::template fn<32, 64>(), a, slots, stats, s);
    if (P == 16) return launch_one<16, 64, CP>(K::template fn<16, 64>(), a, slots, stats, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
inline Args<T> args_from(const void* const* pa, const int* C, const void* const* sk,
                         const int* Cs, const void* kbias, const void* tw, const void* tbias,
                         const void* emb, const void* res, const void* sbias, void* y,
                         void* conv_out, void* partial, int B, int F, int H, int W, int Wp, int D,
                         int silu) {
  Args<T> a;
  parts_from(pa, C, a.p);
  skips_from(sk, Cs, a.q);
  a.kbias = static_cast<const float*>(kbias);
  a.tw = static_cast<const T*>(tw);
  a.tbias = static_cast<const float*>(tbias);
  a.emb = static_cast<const float*>(emb);
  a.res = static_cast<const T*>(res);
  a.sbias = static_cast<const float*>(sbias);
  a.y = static_cast<T*>(y);
  a.conv_out = static_cast<T*>(conv_out);
  a.partial = static_cast<float*>(partial);
  a.B = B;
  a.F = F;
  a.H = H;
  a.W = W;
  a.Wp = Wp;
  a.D = D;
  a.silu = silu;
  return a;
}

// the checks both C entry points make; returns 0 or an error code
inline int check(int B, int F, int H, int W, int Wp, int C0, int C1, int D, int Cs0, int Cs1,
                 int P, int dtype, const void* conv_out, const void* partial, const void* stats,
                 const void* sbias) {
  if (B <= 0 || F <= 0 || H <= 0 || W <= 0 || C0 <= 0 || C0 % KSTEP || C1 % KSTEP ||
      Cs0 % KSTEP || Cs1 % KSTEP || D <= 0 || D % 64 || D / slice_of(D) > MAX_CLUSTER ||
      Wp % 8 || Wp < W + 2 || (P != 16 && P != 32 && P != 64) || (dtype != 0 && dtype != 1) ||
      (partial == nullptr) != (stats == nullptr) || ((Cs0 || Cs1) && !sbias) ||
      (dtype == 0 && !conv_out))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace hop
}  // namespace v2a
