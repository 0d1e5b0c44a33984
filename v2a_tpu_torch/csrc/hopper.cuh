// The Hopper primitives the hand-written tensor-core kernels share (K3, K12
// and K13's mainloop in conv_tconv_hopper.cuh, K6 in wgrad_conv3x3.cu, K1 in
// affine_conv3x3.cu, K14 in winograd_conv3x3.cu): cp.async and TMA copies
// into shared memory, ldmatrix, mma.sync m16n8k16 (bf16 in, float32 sums),
// the 64-byte-row XOR swizzle, weight slabs as mma's B operand and the
// pixel tiling.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace v2a {
namespace hop {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// -- cp.async: 16 bytes a thread, no registers --

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
// 16 bytes, or 16 zero bytes without reading src when !valid
__device__ __forceinline__ void cp_async16_or_zero(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- TMA: one thread issues a whole box; an mbarrier counts its bytes --

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrives once and expects `bytes` more to land
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// waits until the phase of parity `parity` has completed; traps (the
// launch fails) where a copy has not landed within 2^32 clocks (~2 s)
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start < 0) start = clock64();
    else if (clock64() - start > (1ll << 32)) __trap();
  }
}
// orders this thread's generic shared-memory accesses before later TMA
// (async proxy) writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// `bytes` contiguous bytes (16-byte aligned, a multiple of 16)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A bf16 tensor map of `rank` dims (innermost first; strides in bytes of
// dims 1..rank-1) with box `box`, filling out-of-range elements with zero.
// cuTensorMapEncodeTiled comes through the runtime's driver entry point, so
// no library links the driver. Returns 0 or an error code.
inline int encode_tiled(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                        const uint64_t* strides, const uint32_t* box,
                        CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess || !fn)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                            const_cast<void*>(base), dims, strides, box, one,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// -- ldmatrix and mma.sync --

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t r[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 64-byte rows of 32 channels (windows, temporal A tiles): 16-byte chunk ch
// of row r sits at chunk ch ^ ((r >> 1) & 3), so eight consecutive rows
// read by one ldmatrix hit eight different bank groups. It is TMA's 64-byte
// swizzle of rows that start at a 512-byte boundary.
__device__ __forceinline__ uint32_t row64(int r, int ch) {
  return (uint32_t)(r * 64 + ((ch ^ ((r >> 1) & 3)) << 4));
}

// -- weight slabs as mma's B operand (K1, K14) --
//
// A slab is 32 rows (a 32-deep product) x NC columns of a row-major (K, ld)
// bf16 matrix, stored as 64-column halves of 128-byte rows with 16-byte
// chunk ch of row k at chunk ch ^ (k & 7) (TMA's 128-byte swizzle), so
// ldmatrix.trans reads eight rows from eight bank groups. The layout of
// the shared conv mainloop's slabs (conv_tconv_hopper.cuh); K1 and K14 copy
// theirs by TMA into a ring whose stages complete on mbarriers.

constexpr int SLAB_ROWS = 32;
constexpr int SLAB_HALF = SLAB_ROWS * 128;  // bytes of one 64-column half
template <int NC>
__host__ __device__ constexpr int slab_bytes() {
  return SLAB_ROWS * NC * 2;
}

// The map of a row-major (rows, cols) bf16 matrix in boxes of one slab's
// 64-column half (64 x 32, 128-byte swizzle: the slab layout above)
inline int encode_slabs(CUtensorMap* map, const void* w, uint64_t rows, uint64_t cols) {
  const uint64_t dims[2] = {cols, rows}, strides[1] = {cols * 2};
  const uint32_t box[2] = {64, SLAB_ROWS};
  return encode_tiled(map, w, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A kernel's dynamic shared memory, 128-byte aligned, moved up to the
// 128-byte swizzle's period of 1024 bytes (at most ALIGN_PAD bytes, which
// the launch adds to its request); traps on a base that is not 128-byte
// aligned
constexpr int ALIGN_PAD = 1024 - 128;
__device__ __forceinline__ unsigned char* align1024(unsigned char* smem) {
  const uint32_t a = smem_u32(smem);
  if (a & 127) __trap();
  return smem + ((1024 - (a & 1023)) & 1023);
}

// TMA of `nsub` slabs, issued by one thread: slab s holds rows row0 + s *
// step .. + 32, columns n0 .. n0 + NC of the matrix of `map`
// (`encode_slabs`), each 64-column half one 2-D box, and lands at dst + s *
// slab_bytes<NC>(); all complete on mbarrier bar. dst 1024-byte aligned
// (the 128-byte swizzle's period: `align1024`).
template <int NC>
__device__ __forceinline__ void tma_slabs(uint32_t dst, const CUtensorMap* map, int row0,
                                          int step, int nsub, int n0, uint32_t bar) {
  mbar_expect(bar, (uint32_t)(nsub * slab_bytes<NC>()));
  for (int s = 0; s < nsub; ++s)
#pragma unroll
    for (int h = 0; h < NC / 64; ++h)
      tma_load_2d(dst + s * slab_bytes<NC>() + h * SLAB_HALF, map, n0 + 64 * h, row0 + s * step,
                  bar);
}

// k16 step kk of the slab at bb times the A fragments a[MT] of this warp,
// into its NT n8 tiles from column nw of the slab
template <int MT, int NT>
__device__ __forceinline__ void mma_slab(float (&acc)[MT][NT][4], uint32_t bb, int kk,
                                         const uint32_t (&a)[MT][4], int nw, int lane) {
  const int k = kk * 16 + (lane & 15);
  if constexpr (NT == 1) {
    uint32_t q[2];
    ldsm_x2_t(bb + (nw >> 6) * SLAB_HALF + k * 128 + ((((nw >> 3) & 7) ^ (k & 7)) << 4), q);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma16816(acc[mt][0], a[mt], q[0], q[1]);
  } else {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int n = nw + np * 16 + (lane >> 4) * 8;
      uint32_t q[4];
      ldsm_x4_t(bb + (n >> 6) * SLAB_HALF + k * 128 + ((((n >> 3) & 7) ^ (k & 7)) << 4), q);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(acc[mt][2 * np], a[mt], q[0], q[1]);
        mma16816(acc[mt][2 * np + 1], a[mt], q[2], q[3]);
      }
    }
  }
}

// A pixel tile: th rows of tw pixels, as square as 16-byte rows allow
// (8 x 8, 8 x 4, 4 x 4; tw = W where W is narrower), so that its window of
// (th + 2) x (tw + 2) pixels activates each input element about 1.6 times
// where a 1 x 64 strip would 3.1 times; tiles in row-major order over the
// image.
struct Tile {
  int th, tw, tiles_w, tiles;
};
__host__ __device__ inline Tile tile_of(int H, int W, int P) {
  Tile t;
  const int side = P >= 32 ? 8 : 4;
  t.tw = W < side ? W : side;
  t.th = P / t.tw;
  t.tiles_w = (W + t.tw - 1) / t.tw;
  t.tiles = ((H + t.th - 1) / t.th) * t.tiles_w;
  return t;
}

}  // namespace hop
}  // namespace v2a
