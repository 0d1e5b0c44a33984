// K6: dW[di, dj, ci, co] = sum_{n,h,w} s[n, h+di-1, w+dj-1, ci] * g[n, h, w, co],
// the weight gradient of y = conv3x3_same(s) with s = act(x), (3, 3, C, D)
// float32.
//
// Replaces the TPU kernel `wgrad_conv3x3`
// (v2a_tpu/ops/resblock_kernels.py:3329, body `_wgrad3x3_kernel` :3237),
// which activates one VMEM band and takes each tap's shifted view of it.
//
// act(x) = silu(a[n, c] * x + b[n, c]) (mode 2), a[n, c] * x + b[n, c]
// (mode 1) or x (mode 0), from the raw input, rounded to the input type
// before the product and zero for every tap that falls outside the frame
// (after the activation, set by selection). The rounding is K1's: `affine8`
// in common.cuh.
//
// What bounds it on the H100: operations. It is a GEMM with M = 9 C,
// N = D and a very long K = N*H*W pixels (2.2e11 FLOP at 28 x 128^2 x
// 128 -> 128 against ~0.06 GB of traffic); the output is small, so the
// parallelism has to come from the pixels. What the design does about it
// (bf16; the primitives are hopper.cuh's):
//
// - One activated window read by all nine taps. A CTA of twelve warps owns
//   every tap x 32 input channels x 128 output channels (64 where 128 does
//   not divide D; M = 288, N = 128) and walks a chunk of 8 x 8 pixel tiles
//   (`hop::tile_of`). Per tile the raw (th+2) x (tw+2) x 32 window, its
//   sample's a and b, and the 64-pixel tile of g come by cp.async into a
//   4-stage ring (g's rows past the image zero-filled by the copy); the
//   window is activated in place once, a tile ahead of its products,
//   positions outside the image selected to zero. The activation runs
//   about 1.6 x D / 128 times per element, where the wmma kernel this
//   replaces ran it 9 x D / 64 times; each warp runs its share between two
//   of its k16 steps, at a step set by its slot on its scheduler, so that
//   the activation's arithmetic overlaps other warps' products.
// - The products dW[tap] += S_shift(tap)^T G by mma.sync m16n8k16 (bf16 in,
//   float32 sums): A by ldmatrix.trans from the window at the tap's
//   shifted pixel rows (each lane gives its own row address, so a shift
//   costs nothing; 64-byte rows, `row64` swizzle), B by ldmatrix.trans
//   from g's rows (chunks ^ (row & 7)). A warp owns one tap row x 16
//   channels x 64 outputs: 3 m16 x 8 n8 tiles, 96 accumulators a thread
//   (48 at 64-wide blocks).
// - Tile coordinates stepped incrementally (no division per element); the
//   window and g addresses of a thread's vectors fixed per launch.
// - Split-K over pixel chunks, deterministic: the plan (`wgrad_plan` in
//   ops/resblock_kernels.py) gives chunks of whole tiles so that the grid
//   fills the card in whole waves; each chunk writes a float32 partial dW
//   slab and a second pass adds the chunks in chunk order (no float
//   atomics: two launches are bit-equal).
//
// float32 (tests only) keeps a plain CUDA-core product over the same chunks
// of tiles (`WAccum`).
#include "common.cuh"
#include "hopper.cuh"

namespace v2a {
namespace {

using hop::bf16;

constexpr int PIX = 64;          // pixels per tile
constexpr int CB = 32;           // input channels a CTA owns: one 64-byte window row
constexpr int WTHREADS = 384;    // twelve warps: 3 tap rows x 2 channel halves x 2 output halves
constexpr int WSTAGES = 4;       // ring stages: tile j multiplied, j+1 activated, j+2 and j+3 in flight
constexpr int VW = 3;            // window vectors a thread copies and activates (<= 198 rows)

// stage bytes: [g tile, 64 rows of DB][window (th+2)(tw+2) 64-byte rows][a 32][b 32],
// 128-aligned
__host__ __device__ inline int stage_bytes(const hop::Tile& t, int DB) {
  return (PIX * DB * 2 + (t.th + 2) * (t.tw + 2) * 64 + 2 * CB * 4 + 127) / 128 * 128;
}

// the sample and first pixel of a tile, stepped in tile order
struct Cursor {
  int n, h0, w0;
  __device__ void step(const hop::Tile& t, int H, int W) {
    w0 += t.tw;
    if (w0 >= W) {
      w0 = 0;
      h0 += t.th;
      if (h0 >= H) {
        h0 = 0;
        ++n;
      }
    }
  }
};

// DB: output channels a CTA owns (128, or 64 where 128 does not divide D)
template <int DB>
__global__ void __launch_bounds__(WTHREADS, 1)
wgrad_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const bf16* __restrict__ g,
                  float* __restrict__ dst, int H, int W, int C, int D, int tiles_total,
                  int per_chunk, int mode) {
  constexpr int GROW = DB * 2, GBYTES = PIX * GROW;  // g's row and tile bytes
  constexpr int GCH = DB / 8;                        // 16-byte chunks of a g row
  constexpr int VG = (PIX * GCH + WTHREADS - 1) / WTHREADS;  // g vectors a thread copies
  constexpr int NT = DB / 16;                        // n8 tiles a warp owns (half of DB)
  extern __shared__ __align__(128) unsigned char smem[];
  const hop::Tile t = hop::tile_of(H, W, PIX);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cblocks = C / CB;
  const int c0 = (blockIdx.x % cblocks) * CB, d0 = (blockIdx.x / cblocks) * DB;
  const int first = blockIdx.y * per_chunk;
  const int ntile = min(per_chunk, tiles_total - first);
  const int tw2 = t.tw + 2, R = (t.th + 2) * tw2, R4 = R * 4, valid = t.th * t.tw;
  const int sbytes = stage_bytes(t, DB);
  const uint32_t s0 = hop::smem_u32(smem);

  // this thread's copy slots, fixed per launch: window vector i (16 bytes,
  // index tid + 384 i) sits at window row wpos[i] >> 8, col wpos[i] & 255;
  // g vector i at tile row gpos[i] >> 8, col gpos[i] & 255 (-1: past the
  // tile's pixels)
  int wpos[VW], gpos[VG];
#pragma unroll
  for (int i = 0; i < VW; ++i) {
    const int pix = (tid + i * WTHREADS) >> 2;
    wpos[i] = (pix / tw2) << 8 | pix % tw2;
  }
#pragma unroll
  for (int i = 0; i < VG; ++i) {
    const int m = (tid + i * WTHREADS) / GCH;
    gpos[i] = m < valid ? (m / t.tw) << 8 | m % t.tw : -1;
  }

  // the raw window, a, b and the g tile of the tile at cursor q into stage st
  auto issue = [&](int st, const Cursor& q) {
    const uint32_t base = s0 + st * sbytes, wbase = base + GBYTES;
    const bf16* xn = x + (long)q.n * H * W * C + c0;
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      const int v = tid + i * WTHREADS;
      const int hh = q.h0 - 1 + (wpos[i] >> 8), ww = q.w0 - 1 + (wpos[i] & 255);
      if (v < R4 && hh >= 0 && hh < H && ww >= 0 && ww < W)
        hop::cp_async16(wbase + hop::row64(v >> 2, v & 3), xn + (hh * W + ww) * C + (v & 3) * 8);
    }
    if (mode && tid < 16)
      hop::cp_async16(wbase + R * 64 + tid * 16,
                      (tid < 8 ? a : b) + (long)q.n * C + c0 + (tid & 7) * 4);
    const bf16* gn = g + (long)q.n * H * W * D + d0;
#pragma unroll
    for (int i = 0; i < VG; ++i) {
      const int v = tid + i * WTHREADS, m = v / GCH, ch = v % GCH;
      const int hh = q.h0 + (gpos[i] >> 8), ww = q.w0 + (gpos[i] & 255);
      const bool in = gpos[i] >= 0 && hh < H && ww < W;
      if (v < PIX * GCH)
        hop::cp_async16_or_zero(base + m * GROW + ((ch ^ (m & 7)) << 4),
                                in ? gn + (hh * W + ww) * D + ch * 8 : g, in);
    }
  };
  // the window of stage st (tile at cursor q) activated in place, rounded
  // to bf16; positions outside the image selected to zero
  auto activate = [&](int st, const Cursor& q) {
    unsigned char* wb = smem + st * sbytes + GBYTES;
    const float* ab = reinterpret_cast<const float*>(wb + R * 64);
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      const int v = tid + i * WTHREADS;
      if (v >= R4) continue;
      const int hh = q.h0 - 1 + (wpos[i] >> 8), ww = q.w0 - 1 + (wpos[i] & 255);
      bf16* p = reinterpret_cast<bf16*>(wb + hop::row64(v >> 2, v & 3));
      if (hh < 0 || hh >= H || ww < 0 || ww >= W) {
        zero8(p);
      } else if (mode) {
        float v8[8];
        load8(p, v8);
        affine8(v8, ab + (v & 3) * 8, ab + CB + (v & 3) * 8, mode == 2);
        store8(p, v8);
      }
    }
  };

  // warp (tap row di, channel half ch16, output half wn); each lane's A row
  // (window pixel at tap (0, 0)) for each of the tile's four k16 steps
  const int di = warp >> 2, ch16 = (warp >> 1) & 1, wn = warp & 1;
  int kpix[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int m = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
    kpix[kk] = m < valid ? (m / t.tw) * tw2 + m % t.tw + di * tw2 : di * tw2;
  }
  float acc[3][NT][4];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dj][nt][e] = 0.f;
  const int ach = ch16 * 2 + ((lane >> 3) & 1);  // this lane's 16-byte chunk of a window row

  // the pipeline: tile j's products while tile j+1 is activated and tiles
  // j+2, j+3 are in flight; one barrier a tile. A warp activates its part
  // of the next window after k16 step `act_kk` of its products, 0, 1 or 2
  // by the warp's slot on its scheduler, so that while some warps wait on
  // the activation's arithmetic the others keep the tensor cores busy.
  const int tpi = t.tiles, act_kk = warp >> 2;
  Cursor ic{first / tpi, ((first % tpi) / t.tiles_w) * t.th, ((first % tpi) % t.tiles_w) * t.tw};
  Cursor ac = ic;
#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < ntile) {
      issue(s, ic);
      ic.step(t, H, W);
    }
    hop::cp_commit();
  }
  hop::cp_wait<WSTAGES - 2>();
  __syncthreads();
  activate(0, ac);
  ac.step(t, H, W);
  for (int j = 0; j < ntile; ++j) {
    hop::cp_wait<WSTAGES - 3>();
    __syncthreads();
    if (j + WSTAGES - 1 < ntile) {
      issue((j + WSTAGES - 1) % WSTAGES, ic);
      ic.step(t, H, W);
    }
    hop::cp_commit();
    // tile j's products: dW[tap] += S_shift(tap)^T G, k16 step by k16 step
    const uint32_t gb = s0 + (j % WSTAGES) * sbytes, wb = gb + GBYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[3][4];
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) hop::ldsm_x4_t(wb + hop::row64(kpix[kk] + dj, ach), af[dj]);
      const int k = kk * 16 + (lane & 15);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int n = wn * (DB / 2) + np * 16 + (lane >> 4) * 8;
        uint32_t q[4];
        hop::ldsm_x4_t(gb + k * GROW + (((n >> 3) ^ (k & 7)) << 4), q);
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          hop::mma16816(acc[dj][2 * np], af[dj], q[0], q[1]);
          hop::mma16816(acc[dj][2 * np + 1], af[dj], q[2], q[3]);
        }
      }
      if (kk == act_kk && j + 1 < ntile)
        activate((j + 1) % WSTAGES, ac);
    }
    ac.step(t, H, W);
  }
  hop::cp_wait<0>();

  // dst[tap][c][d], this warp's 3 taps x 16 channels x DB / 2 outputs
  float* out = dst + (long)blockIdx.y * 9 * C * D;
#pragma unroll
  for (int dj = 0; dj < 3; ++dj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = c0 + ch16 * 16 + (lane >> 2) + hh * 8;
      float* row = out + ((long)(di * 3 + dj) * C + c) * D + d0 + wn * (DB / 2) + (lane & 3) * 2;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(row + nt * 8) =
            make_float2(acc[dj][nt][2 * hh], acc[dj][nt][2 * hh + 1]);
    }
}

template <int DB>
cudaError_t launch_bf16(const void* x, const float* a, const float* b, const void* g, float* dst,
                        int H, int W, int C, int D, int chunks, int chunk_len, int tiles, int mode,
                        cudaStream_t s) {
  const int smem = WSTAGES * stage_bytes(hop::tile_of(H, W, PIX), DB);
  cudaError_t err = cudaFuncSetAttribute(wgrad_bf16_kernel<DB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wgrad_bf16_kernel<DB><<<dim3((unsigned)(C / CB * (D / DB)), (unsigned)chunks), WTHREADS, smem,
                          s>>>(static_cast<const bf16*>(x), a, b, static_cast<const bf16*>(g),
                               dst, H, W, C, D, tiles, chunk_len, mode);
  return cudaGetLastError();
}

// -- float32 (tests only): the same chunks of tiles on the CUDA cores --

constexpr int WK = 32;  // pixels per shared-memory step
constexpr int FS = BM + 4, FG = BN + 4;

// float32: thread (ty, tx) owns channels ty*8..+8 and outputs tx*4..+4 of a
// 64 x 64 (ci, co) tile
struct WAccum {
  float c[8][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }
  __device__ __forceinline__ void step(float (*Ss)[FS], float (*Gs)[FG]) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < WK; ++k) {
      float4 b = *reinterpret_cast<const float4*>(&Gs[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float a = Ss[k][ty * 8 + i];
        c[i][0] += a * b.x;
        c[i][1] += a * b.y;
        c[i][2] += a * b.z;
        c[i][3] += a * b.w;
      }
    }
  }
};

// block (tap x 64 channels, 64 outputs, chunk); per tile two 32-pixel steps
__global__ void __launch_bounds__(THREADS)
wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ b, const float* __restrict__ g,
                 float* __restrict__ dst, int H, int W, int C, int D, int tiles_total,
                 int per_chunk, int mode) {
  __shared__ __align__(16) float Ss[WK][FS];
  __shared__ __align__(16) float Gs[WK][FG];
  const hop::Tile t = hop::tile_of(H, W, PIX);
  const int cblocks = C / BM;
  const int tap = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x % cblocks) * BM;
  const int n0 = blockIdx.y * BN;
  const int di = tap / 3 - 1, dj = tap % 3 - 1;
  const int first = blockIdx.z * per_chunk;
  const int last = min(first + per_chunk, tiles_total);
  const int tid = threadIdx.x;
  constexpr int SLOTS = (WK * BM) / (THREADS * 8);
  WAccum acc;
  acc.zero();
  for (int tile = first; tile < last; ++tile) {
    const int n = tile / t.tiles, r = tile % t.tiles;
    const int h0 = (r / t.tiles_w) * t.th, w0 = (r % t.tiles_w) * t.tw;
    for (int m0 = 0; m0 < PIX; m0 += WK) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int idx = tid + s * THREADS;
        const int pk = idx / (BM / 8), cg = (idx % (BM / 8)) * 8;
        const int m = m0 + pk;
        const int h = h0 + m / t.tw, w = w0 + m % t.tw;
        float* sdst = &Ss[pk][cg];
        float* gdst = &Gs[pk][cg];
        if (m >= t.th * t.tw || h >= H || w >= W) {
          zero8(sdst);
          zero8(gdst);
          continue;
        }
        copy8(gdst, g + (((long)n * H + h) * W + w) * D + n0 + cg);
        const int hh = h + di, ww = w + dj;
        if (hh < 0 || hh >= H || ww < 0 || ww >= W) {
          zero8(sdst);  // the halo is zero after the activation
          continue;
        }
        const long off = (((long)n * H + hh) * W + ww) * C + c0 + cg;
        float v[8];
        load8(x + off, v);
        if (mode) affine8(v, a + (long)n * C + c0 + cg, b + (long)n * C + c0 + cg, mode == 2);
        store8(sdst, v);
      }
      __syncthreads();
      acc.step(Ss, Gs);
      __syncthreads();
    }
  }
  float* out = dst + (long)blockIdx.z * 9 * C * D;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[((long)tap * C + c0 + ty * 8 + i) * D + n0 + tx * 4 + j] = acc.c[i][j];
}

// dW[i] = sum over chunks of partial[chunk][i], in chunk order.
__global__ void sum_chunks_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                  long n_out, int chunks) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float sum = 0.f;
  for (int k = 0; k < chunks; ++k) sum += partial[(long)k * n_out + i];
  out[i] = sum;
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. mode: 0 plain conv, 1 affine, 2 affine+SiLU.
// The pixels are cut into the tiles of `hop::tile_of(H, W, 64)` over (N,
// tile) in order, `chunks` chunks of `chunk_len` tiles each (the last may be
// shorter; `wgrad_plan`). Needs C % 64 == 0, D % 64 == 0, chunks * chunk_len
// >= N * tiles, 16-byte aligned contiguous buffers; partial holds chunks * 9
// C D floats when chunks > 1 (unused, may be null, when chunks == 1).
extern "C" int v2a_wgrad_conv3x3(const void* x, const void* a, const void* b, const void* g,
                                 void* partial, void* out, int N, int H, int W, int C, int D,
                                 int chunks, int chunk_len, int mode, int dtype, void* stream) {
  using namespace v2a;
  const hop::Tile t = hop::tile_of(H, W, PIX);
  const int tiles = N * t.tiles;
  if (N <= 0 || H <= 0 || W <= 0 || C % BM || D % BN || C <= 0 || D <= 0 || chunks < 1 ||
      chunk_len < 1 || (long)chunks * chunk_len < tiles || (chunks > 1 && partial == nullptr) ||
      mode < 0 || mode > 2 || (mode && (a == nullptr || b == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* dst = chunks > 1 ? static_cast<float*>(partial) : o;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  cudaError_t err;
  if (dtype == 1) {
    err = D % 128 == 0 ? launch_bf16<128>(x, af, bf, g, dst, H, W, C, D, chunks, chunk_len, tiles,
                                          mode, s)
                       : launch_bf16<64>(x, af, bf, g, dst, H, W, C, D, chunks, chunk_len, tiles,
                                         mode, s);
  } else if (dtype == 0) {
    wgrad_f32_kernel<<<dim3((unsigned)(9 * C / BM), (unsigned)(D / BN), (unsigned)chunks),
                       THREADS, 0, s>>>(static_cast<const float*>(x), af, bf,
                                        static_cast<const float*>(g), dst, H, W, C, D, tiles,
                                        chunk_len, mode);
    err = cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const long n_out = 9L * C * D;
  sum_chunks_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(dst, o, n_out, chunks);
  return (int)cudaGetLastError();
}
