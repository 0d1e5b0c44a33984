// K7: GroupNorm(G) with float32 statistics, affine and optional SiLU,
// x (B, S, C) channels-last -> y (B, S, C) in x's type.
//
// Replaces the TPU kernel `fused_group_norm_silu`
// (v2a_tpu/ops/pallas_kernels.py:111, bodies `_stats_kernel` :40 and
// `_apply_kernel` :72).
//
// Per (batch, group): sum and sum of squares over (S, C / G) in float32;
// mean = sum / n, var = sumsq / n - mean^2 (not clamped at zero, as the TPU
// kernel), rstd = rsqrt(var + eps); y = (x - mean) * rstd * scale + bias,
// then y * (1 / (1 + exp(-y))) with silu, each step rounded as the plain
// version rounds it (no fused multiply-add, a correctly rounded
// reciprocal), rounded to T once.
//
// What bounds it on the H100: bytes (a statistics read, then a read and a
// write: 235 MB each at (8, 114688, 128) bf16), as long as enough bytes are
// in flight and the apply pass spends few instructions per byte. Design,
// two launches over one plan (`group_norm_plan` in ops/group_norm.py,
// handed in, checked here): CTAs of (C / 8) vector columns x `lanes` rows,
// `ctas` of them per sample in both passes; CTA i takes its sample's
// chunks of `rows` rows i, i + ctas, ..., so that a sample's CTAs read
// neighbouring rows at any time. One thread streams a CTA's chunks by TMA
// bulk copies through a ring of STAGES shared-memory slots on mbarriers
// (at most 64 bytes a thread a chunk: 48 KB a 256-thread CTA, 192 KB an SM
// in flight), so the threads spend no registers or instructions on the
// loads; a thread owns one 8-channel vector of each row it takes. Four
// CTAs an SM at 64 registers a thread: the apply pass with the SiLU spills
// a few, and three CTAs an SM at 80 registers were slower on the H100.
//   1. statistics: each thread adds its rows in row order, the CTA folds
//      its lanes and each group's channels in a fixed order in shared
//      memory and writes one (sum, sumsq) per group; the last CTA of each
//      sample to arrive (an integer counter, fenced) folds that sample's
//      partials in a fixed order into (mean, rstd) and resets the counter;
//   2. apply: each thread holds its 8 channels' mean, rstd, scale and bias
//      in registers and takes the chunks in the reverse of the statistics
//      pass's order (CTAs too), so its first reads find the rows the
//      statistics pass left in L2; 16-byte stores of y. No division in the
//      loop.
// Deterministic: the plan depends on the shape only, the sums run in a
// fixed order, no float atomics.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace v2a {
namespace {

// rows of a chunk a thread takes at most: four 16-byte vectors (bf16: 4,
// float32: 2)
template <typename T>
__host__ __device__ constexpr int unroll() {
  return 64 / (8 * (int)sizeof(T));
}
constexpr int STAGES = 3;     // the ring's depth
constexpr int RING_OFF = 128;  // the ring's offset in shared memory, after its mbarriers
// dynamic shared memory of either pass: the ring of `rows`-row chunks, or
// the statistics' reduction, [2][lanes][C] floats, where that is larger
template <typename T>
constexpr long smem_bytes(int rows, int lanes, int C) {
  return RING_OFF + std::max((long)STAGES * rows * C * (long)sizeof(T), 8L * lanes * C);
}
constexpr int MOST_SMEM = RING_OFF + STAGES * 64 * 1024;  // 1,024 threads, 64 bytes each

template <bool SILU>
__device__ __forceinline__ void affine_silu(float w[8], const float mean[8], const float rstd[8],
                                            const float sc[8], const float bi[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float t = __fmul_rn(__fsub_rn(w[k], mean[k]), rstd[k]);
    t = __fadd_rn(__fmul_rn(t, sc[k]), bi[k]);
    if (SILU) t = __fmul_rn(t, __frcp_rn(__fadd_rn(1.f, expf(-t))));
    w[k] = t;
  }
}

// A CTA's chunks of its sample's S rows (from `first`), `srows` rows a
// chunk: chunk split, split + ctas, split + 2 ctas, ... (the k-th taken at
// row (k ctas + split) srows), so that at any time the CTAs of a sample
// read neighbouring rows; each comes through the ring of STAGES slots
// after the mbarriers at `bars`.
template <typename T>
struct Ring {
  const T* first;
  unsigned char* smem;
  uint32_t bars;
  int S, srows, C, split, ctas;

  __device__ __forceinline__ int chunks() const {
    const int all = (S + srows - 1) / srows;
    return split < all ? (all - split + ctas - 1) / ctas : 0;
  }
  __device__ __forceinline__ long row0(int k) const { return ((long)k * ctas + split) * srows; }
  __device__ __forceinline__ int rows_of(int k) const {
    const long left = S - row0(k);
    return left < srows ? (int)left : srows;
  }
  __device__ __forceinline__ const T* slot(int s) const {
    return reinterpret_cast<const T*>(smem + RING_OFF + (long)s * srows * C * sizeof(T));
  }
  // thread 0: chunk k into slot s
  __device__ __forceinline__ void issue(int k, int s) const {
    const uint32_t bytes = (uint32_t)rows_of(k) * C * sizeof(T);
    hop::mbar_expect(bars + 8 * s, bytes);
    hop::bulk_load(hop::smem_u32(slot(s)), first + row0(k) * C, bytes, bars + 8 * s);
  }
  // the j-th chunk taken lies in slot j % STAGES, completed at phase j / STAGES
  __device__ __forceinline__ void wait(int j) const {
    hop::mbar_wait(bars + 8 * (j % STAGES), (j / STAGES) & 1);
  }
};

template <typename T>
__device__ __forceinline__ Ring<T> ring_of(const T* x, unsigned char* smem, int S, int C,
                                           int rows, int split, int ctas, int b) {
  Ring<T> g{x + (long)b * S * C, smem, hop::smem_u32(smem), S, rows, C, split, ctas};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) hop::mbar_init(g.bars + 8 * s, 1);
    hop::fence_mbar_init();
  }
  __syncthreads();
  return g;
}

// scratch (float32), each part 16-byte aligned: arrival counters (unsigned,
// one per sample), then (mean, rstd) per (sample, group), then the
// partials: per (sample, group, sum | sumsq) one value per CTA, their rows
// padded to a multiple of 4 CTAs with zeros (never written) so that the
// fold reads them four at a time
__device__ inline long up4(long n) { return (n + 3) / 4 * 4; }
__device__ inline long stats_off(int B) { return up4(B); }
__device__ inline long partials_off(int B, int G) { return up4(B) + up4(2L * B * G); }

template <typename T>
__global__ void __launch_bounds__(1024)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ scratch, int B, int S, int C, int G,
                int rows, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int V = C / 8, lanes = blockDim.x / V, ctas = gridDim.x;
  const int split = blockIdx.x, b = blockIdx.y;
  const int v = threadIdx.x % V, rr = threadIdx.x / V;
  const Ring<T> g = ring_of(x, smem, S, C, rows, split, ctas, b);
  const int nst = g.chunks();
  if (threadIdx.x == 0)
    for (int k = 0; k < min(STAGES, nst); ++k) g.issue(k, k);
  float s[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = q[k] = 0.f;
  for (int k = 0; k < nst; ++k) {  // chunks in row order, a thread's rows in row order
    g.wait(k);
    const T* st = g.slot(k % STAGES) + v * 8;
    const int nk = g.rows_of(k);
#pragma unroll
    for (int u = 0; u < unroll<T>(); ++u) {
      const int r = rr + u * lanes;
      if (r < nk) {
        float w[8];
        load8(st + (long)r * C, w);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] = __fadd_rn(s[i], w[i]);
          q[i] = __fadd_rn(q[i], __fmul_rn(w[i], w[i]));
        }
      }
    }
    __syncthreads();  // the slot is read: refill it
    if (threadIdx.x == 0 && k + STAGES < nst) {
      hop::fence_proxy_async();
      g.issue(k + STAGES, k % STAGES);
    }
  }
  // the ring is drained: its first bytes hold the reduction, [2][lanes][C],
  // then the fold's [chunks][2G]
  float* red = reinterpret_cast<float*>(smem + RING_OFF);
  float* rs = red + (long)rr * C + v * 8;
  float* rq = red + (long)(lanes + rr) * C + v * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    rs[k] = s[k];
    rq[k] = q[k];
  }
  __syncthreads();
  // each channel's lanes in lane order, into lane 0's row
  for (int t = threadIdx.x; t < 2 * C; t += blockDim.x) {
    float* col = red + (long)(t / C) * lanes * C + t % C;
    float acc = col[0];
    for (int l = 1; l < lanes; ++l) acc = __fadd_rn(acc, col[(long)l * C]);
    col[0] = acc;
  }
  __syncthreads();
  // each group's channels in channel order, into partial[b][g][sum | sumsq][split]
  const int gw = C / G;
  const long row = up4(ctas);
  float* partial = scratch + partials_off(B, G) + (long)b * 2 * G * row;
  for (int t = threadIdx.x; t < 2 * G; t += blockDim.x) {
    const float* col = red + (long)(t & 1) * lanes * C + (t >> 1) * gw;
    float acc = col[0];
    for (int c = 1; c < gw; ++c) acc = __fadd_rn(acc, col[c]);
    partial[t * row + split] = acc;
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  unsigned* arrived = reinterpret_cast<unsigned*>(scratch) + b;
  if (threadIdx.x == 0) {
    last = atomicAdd(arrived, 1u) == (unsigned)ctas - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // the sample's last CTA: its CTAs' partials in `chunks` runs of CTAs, each
  // run in CTA order, four CTAs a load, then the runs in order
  const int quads = (int)(row / 4);
  const int chunks = max(1, min(quads, (int)blockDim.x / (2 * G)));
  const int per = (quads + chunks - 1) / chunks;
  for (int t = threadIdx.x; t < chunks * 2 * G; t += blockDim.x) {
    const int j = t % (2 * G), k = t / (2 * G);
    const float4* src = reinterpret_cast<const float4*>(partial + j * row);
    const int q1 = min(quads, (k + 1) * per);
    float acc = 0.f;
#pragma unroll 8
    for (int q = k * per; q < q1; ++q) {
      const float4 p = __ldcg(src + q);
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, p.x), p.y), p.z), p.w);
    }
    red[t] = acc;
  }
  __syncthreads();
  const float cnt = (float)((double)S * gw);
  float* mean_rstd = scratch + stats_off(B) + 2L * b * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float sum = red[2 * g], sumsq = red[2 * g + 1];
    for (int k = 1; k < chunks; ++k) {
      sum = __fadd_rn(sum, red[k * 2 * G + 2 * g]);
      sumsq = __fadd_rn(sumsq, red[k * 2 * G + 2 * g + 1]);
    }
    const float mean = __fdiv_rn(sum, cnt);
    const float var = __fsub_rn(__fdiv_rn(sumsq, cnt), __fmul_rn(mean, mean));
    mean_rstd[2 * g] = mean;
    mean_rstd[2 * g + 1] = rsqrtf(__fadd_rn(var, eps));
  }
  if (threadIdx.x == 0) *arrived = 0u;  // for the next launch on this scratch
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(1024)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scratch,
                const float* __restrict__ scale, const float* __restrict__ bias,
                T* __restrict__ y, int B, int S, int C, int G, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int V = C / 8, lanes = blockDim.x / V, ctas = gridDim.x;
  // the statistics pass's CTAs in reverse: its last rows first
  const int split = ctas - 1 - (int)blockIdx.x, b = B - 1 - (int)blockIdx.y;
  const int v = threadIdx.x % V, rr = threadIdx.x / V;
  const Ring<T> g = ring_of(x, smem, S, C, rows, split, ctas, b);
  const int nst = g.chunks();
  if (threadIdx.x == 0)  // the j-th chunk taken is chunk nst - 1 - j
    for (int j = 0; j < min(STAGES, nst); ++j) g.issue(nst - 1 - j, j);
  const int gw = C / G;
  const float* mr = scratch + stats_off(B) + 2L * b * G;
  float mean[8], rstd[8], sc[8], bi[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = v * 8 + k, grp = c / gw;
    mean[k] = mr[2 * grp];
    rstd[k] = mr[2 * grp + 1];
    sc[k] = scale[c];
    bi[k] = bias[c];
  }
  T* yb = y + (long)b * S * C + v * 8;
  for (int j = 0; j < nst; ++j) {
    const int k = nst - 1 - j;
    g.wait(j);
    const T* st = g.slot(j % STAGES) + v * 8;
    T* dst = yb + g.row0(k) * C;
    const int nk = g.rows_of(k);
#pragma unroll
    for (int u = unroll<T>() - 1; u >= 0; --u) {
      const int r = rr + u * lanes;
      if (r < nk) {
        float w[8];
        load8(st + (long)r * C, w);
        affine_silu<SILU>(w, mean, rstd, sc, bi);
        store8(dst + (long)r * C, w);
      }
    }
    __syncthreads();  // the slot is read: refill it
    if (threadIdx.x == 0 && j + STAGES < nst) {
      hop::fence_proxy_async();
      g.issue(k - STAGES, j % STAGES);
    }
  }
}

// opts every K7 kernel into the most dynamic shared memory a plan asks
// (1,024 threads), once per device
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  const void* kernels[] = {
      (const void*)gn_stats_kernel<float>,           (const void*)gn_stats_kernel<__nv_bfloat16>,
      (const void*)gn_apply_kernel<float, false>,    (const void*)gn_apply_kernel<float, true>,
      (const void*)gn_apply_kernel<__nv_bfloat16, false>,
      (const void*)gn_apply_kernel<__nv_bfloat16, true>};
  for (const void* k : kernels) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MOST_SMEM);
    if (e != cudaSuccess) return e;
  }
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* scratch, void* y,
                   int B, int S, int C, int G, int threads, int rows, int ctas, bool silu,
                   float eps, cudaStream_t stream) {
  const int lanes = threads / (C / 8);
  if (rows > lanes * unroll<T>()) return cudaErrorInvalidValue;  // 64 bytes a thread at most
  const long smem = smem_bytes<T>(rows, lanes, C);
  auto apply = silu ? gn_apply_kernel<T, true> : gn_apply_kernel<T, false>;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return e;
  const dim3 grid(ctas, B);
  gn_stats_kernel<T><<<grid, threads, smem, stream>>>(static_cast<const T*>(x),
                                                      static_cast<float*>(scratch), B, S, C, G,
                                                      rows, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  apply<<<grid, threads, smem, stream>>>(static_cast<const T*>(x),
                                         static_cast<const float*>(scratch),
                                         static_cast<const float*>(scale),
                                         static_cast<const float*>(bias), static_cast<T*>(y), B,
                                         S, C, G, rows);
  return cudaGetLastError();
}

}  // namespace
}  // namespace v2a

// dtype: 0 = float32, 1 = bfloat16. x, y (B, S, C); scale, bias (C,)
// float32; scratch float32, its counters zero (each launch leaves them
// zero). threads, rows, ctas: `group_norm_plan`'s, checked here (threads a
// multiple of C / 8 up to 1024, chunks of `rows` rows that give each lane
// at most 64 bytes, every CTA at least one chunk). Needs C % G == 0,
// C % 8 == 0, C <= 8192, 16-byte aligned buffers.
extern "C" int v2a_group_norm_silu(const void* x, const void* scale, const void* bias,
                                   void* scratch, void* y, int B, int S, int C, int G,
                                   int threads, int rows, int ctas, int silu, int dtype,
                                   float eps, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || C <= 0 || C % G || C % 8 || C > 8192 || threads <= 0 ||
      threads > 1024 || threads % (C / 8) || rows <= 0 || ctas <= 0 ||
      (long)(ctas - 1) * rows >= S || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)v2a::launch<__nv_bfloat16>(x, scale, bias, scratch, y, B, S, C, G, threads,
                                           rows, ctas, silu != 0, eps, s);
  if (dtype == 0)
    return (int)v2a::launch<float>(x, scale, bias, scratch, y, B, S, C, G, threads, rows, ctas,
                                   silu != 0, eps, s);
  return (int)cudaErrorInvalidValue;
}
