// Hopper tile of the iMAP* decoder: the forward and backward building
// blocks of K1 (fused_vg.cu), K2 (p1_sigma.cu) and the render megakernel
// pair K3/K4 (megakernel.cu), for sm_90a.
//
// Replaces, on those kernels, the WMMA tile of mlp_tile.cuh /
// vg_shared.cuh (which K5/K6 keep). The TPU kernels are the JAX
// reference's ops/fused_vg.py:304 `_make_vg_kernel` (K1), :284
// `_make_p1_kernel` (K2) and ops/megakernel.py:393 / :480 (K3 / K4).
//
// What bounds the work on the H100 (989 TFLOP/s bf16, 3.35 TB/s): the
// decoder is 2 x (93*256 + 3*256*256 + 256*4) = 442,880 FLOP per point and
// pass; K1's mapper call (379,848 points padded to 380,928) runs the
// forward, the dh chain and the weight gradients, 0.510 ms of tensor-core
// time. Spilling the activations between those three kernels has a byte
// floor: forward writes emb and h0..h3 (877 MB), the chain reads h and
// writes dh (780 + 780 MB), the weight gradients read emb, h0..h2 and dh
// (683 + 780 MB): ~3.9 GB, ~1.17 ms. With the bit masks below, this
// design's floor is ~3.4 GB, ~1.02 ms: forward 877 MB of values and 49 MB
// of masks, chain 195 MB of h3 (for dWo), 49 MB of masks and 780 MB of dh,
// weight gradients 1463 MB. K2 (no spill) is bound by operations.
//
// The design, against those bounds:
//  - one block per SM, persistent over 128-point tiles: warpgroups 0-1
//    are consumers (64 rows each), warpgroup 2 the producer (one thread
//    issues cp.async.bulk copies completed on mbarriers); setmaxnreg moves
//    the producer to 40 registers and the consumers to 232;
//  - the bf16 weights (~0.45 MB, over a block's 227 KB) stream through a
//    ring of 32 KB K-slices (4 stages; 3 in the chain, whose shared memory
//    also holds its sums); ops/fused_vg.py `pack_weights` lays
//    each slice out as the 128-byte-swizzled K-major image that wgmma
//    reads, so a plain 1-D bulk copy lands it ready to use;
//  - wgmma.mma_async m64n256k16 (bf16 in, f32 accumulate); a layer's
//    activations stay on chip: bias, ReLU and bf16 rounding happen on the
//    accumulator registers, which are written once to the warpgroup's
//    swizzled shared tile, the next layer's A operand (no 16x16 staging);
//  - L2 policies keep the weight slices resident (evict_last) while the
//    spills stream past them (evict_first);
//  - spills leave by one 32 KB bulk store per layer and warpgroup: the
//    spill layout is the shared tile's own image, 64-point blocks of
//    128-byte-swizzled 64-column chunks, which is also the MN-major layout
//    the weight-gradient GEMM's bulk loads need;
//  - ReLU masks leave as bits in the accumulator's register order (16
//    bytes per thread and layer), so the chain reads 32 bytes per point and
//    layer instead of h (512 bytes; it still reads h3 for dWo);
//  - weight gradients: a wgmma GEMM over the points (MN-major operands,
//    128 x 256 output tiles, split-K over 18 splits, 126 blocks), partials
//    summed by the ordered reduce_rows: no atomics, bit-reproducible.
//
// Numerics, as the WMMA version and the TPU kernels: x . B is the float32
// FMA chain fma(x2, B2, fma(x1, B1, x0 * B0)) under -fmad=false, emb =
// sinf of it, rounded to bf16; hidden products bf16 x bf16 with f32 sums;
// the head (256 -> 4) on CUDA cores from the bf16-rounded h3: each thread
// sums its 64 columns in order, then the four threads of a quad add by
// shfl_xor 1 then 2, then + bo; the chain rounds its cotangents to bf16
// before each product; sigma is 100 outside the AABB.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

typedef __nv_bfloat16 bf16;

constexpr int HID = 256;
constexpr int EMB = 128;            // Fourier columns padded 93 -> 128
constexpr int TILE = 128;           // points per tile (2 warpgroups x 64)
constexpr int NTHR = 384;           // 2 consumer warpgroups + producer
constexpr int NSTAGE = 4;           // weight-ring stages
constexpr int SLICE = 64 * HID * 2; // one ring stage: 64 K-rows x 256 bf16
constexpr int ATILE = 64 * HID * 2; // one warpgroup's activation tile
constexpr int CHUNK_B = 64 * 128;   // 64 rows x one 128-byte swizzle row
constexpr int FWD_SLICES = 2 + 3 * 4;      // K-slices per forward tile
constexpr int CHAIN_SLICES = 3 * 4 + 4;    // per chain tile (last 4: 16 KB)
constexpr int NSPLIT_W = 18;        // weight-gradient K splits (7 x 18 blocks)
constexpr int WG_MTILES = 7;        // 128-row output tiles: 1 + 3 x 2

// The decoder in the kernels' layout (the Python wrapper's pointer array):
// Bp (3,128) f32, W0p..W3, Wo (256,4) bf16, b0..b3, bo f32, then the two
// swizzled slice images: wf (forward, 14 slices) and wc (chain, 16 slices).
struct Weights {
  const float* Bp;
  const bf16* Wo;
  const float* b[5];
  const bf16* wf;
  const bf16* wc;
};

inline Weights weights_from(const void* const* w) {
  Weights r;
  r.Bp = static_cast<const float*>(w[0]);
  r.Wo = static_cast<const bf16*>(w[5]);
  for (int i = 0; i < 5; ++i) r.b[i] = static_cast<const float*>(w[6 + i]);
  r.wf = static_cast<const bf16*>(w[11]);
  r.wc = static_cast<const bf16*>(w[12]);
  return r;
}

// ---- PTX helpers ---------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A phase
// that never completes (a pipeline bug) traps after ~10 s instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint32_t ok = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
    if (ok) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// L2 policies: the weight slices, re-read by every tile, stay (evict_last);
// the spill stores go first (evict_first: without it the chain's 780 MB of
// dh evicts the weights and the ring waits on device memory); the weight
// gradients' spill loads, shared by the 7 blocks of a split, are normal
__device__ __forceinline__ uint64_t l2_keep() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_normal() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_stream() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                         uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes), "l"(l2_stream())
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the issuing thread's bulk stores have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// generic-proxy writes to shared memory become visible to wgmma / bulk copies
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// wgmma shared-memory descriptor, 128-byte swizzle. lbo / sbo in bytes:
// K-major tiles (forward, chain) use sbo = 1024 (8 rows of 128 bytes);
// MN-major tiles (weight gradients) use lbo = stride between 64-element
// MN groups and sbo = 1024 (8 K-rows).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Byte offset of element (row, col) of a bf16 tile stored as 64-column
// chunks (64 rows x 128 bytes each, CHUNK_B apart), 128-byte swizzled: the
// 16-byte group g of a row sits at g ^ (row % 8). The tile's base is
// 1024-byte aligned.
__device__ __forceinline__ uint32_t sw_off(int row, int col) {
  const int kc = col >> 6, within = (col & 63) * 2;
  return kc * CHUNK_B + row * 128 + ((((within >> 4) ^ (row & 7))) << 4) +
         (within & 15);
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}


// ---- small device helpers -------------------------------------------------
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// x . Bp[:, l] as fma(x2, B2, fma(x1, B1, x0 * B0)) (XLA's CPU dot order)
__device__ __forceinline__ float xdotb(const float* x, const float* Bp,
                                       int l) {
  return __fmaf_rn(x[2], Bp[2 * EMB + l],
                   __fmaf_rn(x[1], Bp[EMB + l], __fmul_rn(x[0], Bp[l])));
}

__device__ __forceinline__ bool inside(const float* x, const float* b6) {
  return x[0] > b6[0] && x[0] < b6[1] && x[1] > b6[2] && x[1] < b6[3] &&
         x[2] > b6[4] && x[2] < b6[5];
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);   // .x = a, lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2b(bf16 a, bf16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// Ring bookkeeping: item `it` of the stream sits in stage it % S and is the
// (it / S)-th use of that stage.
template <int S>
__device__ __forceinline__ void ring_produce(uint64_t* full, uint64_t* empty,
                                             unsigned char* ring, int it,
                                             const void* src, uint32_t bytes) {
  const int st = it % S;
  mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
  mbar_expect_tx(&full[st], bytes);
  bulk_g2s(ring + st * SLICE, src, bytes, &full[st], l2_keep());
}

// Accumulator layout of wgmma m64nNk16 (f32) for thread t of a warpgroup:
// element 4j+e sits at row 16*(t/32) + (t%32)/4 + 8*(e/2), column
// 8j + 2*(t%4) + e%2.
#define ACC_ROW(r0, e) ((r0) + 8 * ((e) >> 1))
#define ACC_COL(j, q, e) (8 * (j) + 2 * (q) + ((e)&1))

// Consumer side of one K-slice: wait for it, run the four k16 steps of
// out[64 x N] += A[:, 64 s .. 64 s + 63] @ slice, and release the previous
// slice once its products are done (one arrival per consumer warp).
template <int S, int N, typename Acc>
__device__ __forceinline__ void ring_consume(uint64_t* full, uint64_t* empty,
                                             unsigned char* ring, int it,
                                             const unsigned char* Achunk,
                                             Acc& acc, bool first) {
  const int st = it % S;
  mbar_wait(&full[st], (it / S) & 1);
  wg_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t da = desc_sw128(Achunk + k * 32, 16, 1024);
    const uint64_t db = desc_sw128(ring + st * SLICE + k * 32, 16, 1024);
    if constexpr (N == 256)
      wgmma_n256<0, 0>(acc, da, db, (first && k == 0) ? 0 : 1);
    else
      wgmma_n128<0, 0>(acc, da, db, (first && k == 0) ? 0 : 1);
  }
  wg_commit();
  if (!first) {
    wg_wait<1>();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[(it - 1) % S]);
  }
}

template <int S>
__device__ __forceinline__ void ring_drain(uint64_t* empty, int it_last) {
  wg_wait<0>();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[it_last % S]);
}

// ---- forward tile (K2 and K1's forward) ---------------------------------
// MODE 0: pass-1 sigma (K2): points z = 0.01 gt_d (1 - t) + far t, writes
//         sig (100 outside the AABB), nothing else;
// MODE 1: K1's forward over the z2 (+ regulation) points: writes x4, raw
//         and the ReLU bit masks of h0..h3;
// MODE 2: MODE 1 and the bf16 spill of emb and h0..h3 (weight gradients).
struct FwdIO {
  const float* rays;     // (n, 8) [o, d, gt_d, far]
  const float* z2;       // (n, S2)
  const float* treg;     // (n, SR)
  const float* bound6;
  float* x4;             // (Ppad, 4)
  float* raw;            // (Ppad, 4)
  float* sig;            // (n, S1), MODE 0
  bf16* emb;             // spill blocks, MODE 2
  bf16* h[4];
  uint4* masks;          // (4, ntiles * 2, 128) uint4
  long P;                // real points (MODE 0: n * S1)
  long ntiles;
  int S1, S2, SR;
};

constexpr int F_RING = 0;
constexpr int F_A = NSTAGE * SLICE;
constexpr int F_XS = F_A + 2 * ATILE;
constexpr int F_BIAS = F_XS + TILE * 16;
constexpr int F_WO = F_BIAS + 4 * HID * 4;
constexpr int F_BP = F_WO + HID * 16;
constexpr int F_MISC = F_BP + 3 * EMB * 4;       // bo (4), b6 (6)
constexpr int F_BAR = F_MISC + 64;
constexpr int F_SMEM = F_BAR + 2 * NSTAGE * 8 + 1024;

__device__ __forceinline__ void point_of(const FwdIO& io, int mode, long p,
                                         float* xo) {
  float x = 0.f, y = 0.f, zc = 0.f, z = 0.f;
  if (p < io.P) {
    if (mode == 0) {
      const float* ray = io.rays + (p / io.S1) * 8;
      const float tv = (float)(p % io.S1) / (float)(io.S1 - 1);
      z = 0.01f * ray[6] * (1.f - tv) + ray[7] * tv;
      x = ray[0] + ray[3] * z;
      y = ray[1] + ray[4] * z;
      zc = ray[2] + ray[5] * z;
    } else {
      const int SP = io.S2 + io.SR;
      const long r = p / SP;
      const int s = (int)(p % SP);
      const float* ray = io.rays + r * 8;
      if (s < io.S2) {
        z = io.z2[r * io.S2 + s];
      } else {
        // stratified-perturbed regulation depth over [0, 0.85 gt_d]
        const int j = s - io.S2, SR = io.SR;
        const float g = 0.85f * ray[6];
        auto base = [&](int k) { return g * ((float)k / (float)(SR - 1)); };
        const float lo = j > 0 ? 0.5f * (base(j) + base(j - 1)) : base(0);
        const float hi =
            j < SR - 1 ? 0.5f * (base(j + 1) + base(j)) : base(SR - 1);
        z = lo + (hi - lo) * io.treg[r * SR + j];
      }
      x = ray[0] + ray[3] * z;
      y = ray[1] + ray[4] * z;
      zc = ray[2] + ray[5] * z;
    }
  }
  xo[0] = x;
  xo[1] = y;
  xo[2] = zc;
  xo[3] = z;
}

template <int MODE>
__global__ void __launch_bounds__(NTHR, 1) fwd_kernel(Weights w, FwdIO io) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* ring = sm + F_RING;
  float* biasS = reinterpret_cast<float*>(sm + F_BIAS);
  float* woS = reinterpret_cast<float*>(sm + F_WO);
  float* BpS = reinterpret_cast<float*>(sm + F_BP);
  float* boS = reinterpret_cast<float*>(sm + F_MISC);
  float* b6 = boS + 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + F_BAR);
  uint64_t* empty = full + NSTAGE;
  const int tid = threadIdx.x;
  for (int i = tid; i < 4 * HID; i += NTHR) biasS[i] = w.b[i / HID][i % HID];
  for (int i = tid; i < 4 * HID; i += NTHR) woS[i] = __bfloat162float(w.Wo[i]);
  for (int i = tid; i < 3 * EMB; i += NTHR) BpS[i] = w.Bp[i];
  if (tid < 4) boS[tid] = w.b[4][tid];
  if (tid < 6) b6[tid] = io.bound6[tid];
  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer: the 14 forward K-slices per tile, in order
    reg_dealloc<40>();
    if (tid == 256) {
      int it = 0;
      for (long tile = blockIdx.x; tile < io.ntiles; tile += gridDim.x)
        for (int s = 0; s < FWD_SLICES; ++s, ++it)
          ring_produce<NSTAGE>(full, empty, ring, it,
                               reinterpret_cast<const char*>(w.wf) +
                                   (size_t)s * SLICE,
                               SLICE);
    }
  } else {
    reg_alloc<232>();
    const int g = tid / 128, t = tid & 127;
    const int lane = t & 31, q = lane & 3;
    const int r0 = (t >> 5) * 16 + (lane >> 2);
    const int wgbar = 1 + g;
    unsigned char* A = sm + F_A + g * ATILE;
    float* xs = reinterpret_cast<float*>(sm + F_XS) + g * 64 * 4;
    int it = 0;
    for (long tile = blockIdx.x; tile < io.ntiles; tile += gridDim.x) {
      const long pb = tile * TILE + g * 64;
      const long blk = tile * 2 + g;
      if (MODE == 2 && t == 0) bulk_wait_read();
      bar_sync(wgbar, 128);     // the last tile's readers of xs and A are done
      if (t < 64) {
        float xo[4];
        point_of(io, MODE, pb + t, xo);
        *reinterpret_cast<float4*>(xs + t * 4) =
            make_float4(xo[0], xo[1], xo[2], xo[3]);
        if (MODE > 0)
          *reinterpret_cast<float4*>(io.x4 + (pb + t) * 4) =
              make_float4(xo[0], xo[1], xo[2], xo[3]);
      }
      bar_sync(wgbar, 128);
      // emb = sin(x . B) -> bf16, 8 columns (16 bytes) per store
      for (int e = t; e < 64 * 16; e += 128) {
        const int row = e >> 4, c0 = (e & 15) * 8;
        const float* x = xs + row * 4;
        uint32_t pk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pk[i] = pack2(sinf(xdotb(x, BpS, c0 + 2 * i)),
                        sinf(xdotb(x, BpS, c0 + 2 * i + 1)));
        *reinterpret_cast<uint4*>(A + sw_off(row, c0)) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
      }
      fence_async_smem();
      bar_sync(wgbar, 128);
      if (MODE == 2 && t == 0) bulk_s2g(io.emb + blk * 64 * EMB, A, CHUNK_B * 2);

      float acc[128];
#pragma unroll 1
      for (int l = 0; l < 4; ++l) {
        const int ns = l == 0 ? 2 : 4;
        for (int s = 0; s < ns; ++s, ++it)
          ring_consume<NSTAGE, 256>(full, empty, ring, it, A + s * CHUNK_B,
                                    acc, s == 0);
        ring_drain<NSTAGE>(empty, it - 1);
        if (MODE == 2 && t == 0) bulk_wait_read();
        bar_sync(wgbar, 128);   // every warp's products have read A
        const float* bias = biasS + l * HID;
        const bool keep = l < 3 || MODE == 2;
        uint32_t mk[4] = {0u, 0u, 0u, 0u};
        float hs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int c = 8 * j + 2 * q;
          const float2 bb = *reinterpret_cast<const float2*>(bias + c);
          bf16 hb[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hb[e] = __float2bfloat16(fmaxf(acc[4 * j + e] + (e & 1 ? bb.y : bb.x), 0.f));
            if (__bfloat162float(hb[e]) > 0.f)
              mk[(4 * j + e) >> 5] |= 1u << ((4 * j + e) & 31);
          }
          if (keep) {
            *reinterpret_cast<uint32_t*>(A + sw_off(r0, c)) = pack2b(hb[0], hb[1]);
            *reinterpret_cast<uint32_t*>(A + sw_off(r0 + 8, c)) = pack2b(hb[2], hb[3]);
          }
          if (l == 3) {
            const float4 w0 = *reinterpret_cast<const float4*>(woS + c * 4);
            const float4 w1 = *reinterpret_cast<const float4*>(woS + c * 4 + 4);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float a = __bfloat162float(hb[2 * hf]);
              const float b = __bfloat162float(hb[2 * hf + 1]);
              hs[4 * hf + 0] += a * w0.x; hs[4 * hf + 0] += b * w1.x;
              hs[4 * hf + 1] += a * w0.y; hs[4 * hf + 1] += b * w1.y;
              hs[4 * hf + 2] += a * w0.z; hs[4 * hf + 2] += b * w1.z;
              hs[4 * hf + 3] += a * w0.w; hs[4 * hf + 3] += b * w1.w;
            }
          }
        }
        if (MODE > 0)
          io.masks[((size_t)l * io.ntiles * 2 + blk) * 128 + t] =
              make_uint4(mk[0], mk[1], mk[2], mk[3]);
        if (keep) {
          fence_async_smem();
          bar_sync(wgbar, 128);
          if (MODE == 2 && t == 0) bulk_s2g(io.h[l] + blk * 64 * HID, A, ATILE);
        }
        if (l == 3) {
#pragma unroll
          for (int i = 0; i < 8; ++i) hs[i] += __shfl_xor_sync(0xffffffffu, hs[i], 1);
#pragma unroll
          for (int i = 0; i < 8; ++i) hs[i] += __shfl_xor_sync(0xffffffffu, hs[i], 2);
          if (q == 0) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = r0 + 8 * hf;
              const long p = pb + row;
              if (MODE == 0) {
                if (p < io.P)
                  io.sig[p] = inside(xs + row * 4, b6) ? hs[4 * hf + 3] + boS[3]
                                                       : 100.f;
              } else {
                *reinterpret_cast<float4*>(io.raw + p * 4) = make_float4(
                    hs[4 * hf] + boS[0], hs[4 * hf + 1] + boS[1],
                    hs[4 * hf + 2] + boS[2], hs[4 * hf + 3] + boS[3]);
              }
            }
          }
        }
      }
    }
    if (MODE == 2 && t == 0) bulk_wait_all();
  }
}

// MODE 0's points: S1 stratified depths of each of the n rays (K2, and
// K3's pass 1: the same tiles, so the same sigma bit for bit)
inline FwdIO pass1_io(const float* rays, const float* bound6, float* sig1,
                      int n, int S1) {
  FwdIO io{};
  io.rays = rays;
  io.bound6 = bound6;
  io.sig = sig1;
  io.P = (long)n * S1;
  io.ntiles = (io.P + TILE - 1) / TILE;
  io.S1 = S1;
  return io;
}

inline int num_sms() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int MODE>
cudaError_t launch_fwd(const Weights& w, const FwdIO& io, cudaStream_t st) {
  if (io.ntiles <= 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (e != cudaSuccess) return e;
  const long grid = io.ntiles < num_sms() ? io.ntiles : num_sms();
  fwd_kernel<MODE><<<(int)grid, NTHR, F_SMEM, st>>>(w, io);
  return cudaGetLastError();
}

// ---- dh chain (K1's backward over the spilled masks) -------------------
// Per 128-point tile: the head backward as a rank-4 product in registers,
// dh_{L-1} = (dh_L @ W_L^T) * (h_{L-1} > 0) for L = 3, 2, 1 with W_L^T
// streamed as K-major slices (wc), demb = (dh0 @ W0p^T) * cos(x . B), then
// per-point dx (DRAY) and, with weight gradients (PG), the bf16 spill of
// dh0..dh3 and per-block sums of the bias, head and B gradients.
// small per-block gradient sums, in the order of the flat gradient buffer:
// dB (3 x 128) | db0..db3 (4 x 256) | dWo (256 x 4) | dbo (4)
constexpr int SMALL_B = 0, SMALL_BIAS = 384, SMALL_WO = 1408, SMALL_BO = 2432;
constexpr int SMALL = 2436;
constexpr int CSTAGE = 3;           // chain ring stages (shared memory)

struct ChainIO {
  const float* x4;       // (Ppad, 4)
  const float* dhead;    // (Ppad, 4)
  const bf16* h3;        // spill blocks (PG)
  const uint4* masks;    // from the forward
  bf16* dh[4];           // spill blocks (PG)
  float* dx;             // (Ppad, 3) (DRAY)
  float* small;          // (gridDim.x, SMALL) (PG)
  long ntiles;
};

constexpr int C_RING = 0;
constexpr int C_A = CSTAGE * SLICE;
constexpr int C_XS = C_A + 2 * ATILE;
constexpr int C_GS = C_XS + TILE * 16;
constexpr int C_PART = C_GS + TILE * 16;          // 2 x 8 warps x 256 f32
constexpr int C_DBSUM = C_PART + 2 * 8 * HID * 4;
constexpr int C_DBS = C_DBSUM + 4 * HID * 4;
constexpr int C_DWO = C_DBS + 384 * 4;             // dWo (256 x 4), dbo
constexpr int C_DBOP = C_DWO + (HID + 1) * 16;    // 4 warps x dbo
constexpr int C_WO = C_DBOP + 64;
constexpr int C_BP = C_WO + HID * 16;
constexpr int C_BAR = C_BP + 3 * EMB * 4;
constexpr int C_SMEM = C_BAR + 2 * CSTAGE * 8 + 1024;

__device__ __forceinline__ bool bit(const uint4& m, int i) {
  const uint32_t w = i < 32 ? m.x : i < 64 ? m.y : i < 96 ? m.z : m.w;
  return (w >> (i & 31)) & 1u;
}

// One layer's cotangent (acc: masked f32, accumulator layout) -> bias sums
// (PG, ordered over the 8 consumer warps), bf16 into A (the next product's
// A operand) and its spill (PG). A must be free (callers synchronise).
template <bool PG>
__device__ __forceinline__ void chain_epilogue(
    float (&acc)[128], unsigned char* A, float* part, float* dbsum, bf16* dst,
    long blk, int g, int t, int wgbar) {
  const int lane = t & 31, q = lane & 3, r0 = (t >> 5) * 16 + (lane >> 2);
  const int ct = g * 128 + t;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (PG) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = acc[4 * j + e] + acc[4 * j + 2 + e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 4) part[(g * 4 + (t >> 5)) * HID + ACC_COL(j, q, e)] = s;
      }
    }
    const int c = 8 * j + 2 * q;
    *reinterpret_cast<uint32_t*>(A + sw_off(r0, c)) =
        pack2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(A + sw_off(r0 + 8, c)) =
        pack2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  fence_async_smem();
  bar_sync(wgbar, 128);
  if (PG) {
    if (t == 0) bulk_s2g(dst + blk * 64 * HID, A, ATILE);
    bar_sync(3, 256);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += part[i * HID + ct];
    dbsum[ct] += s;
  }
}

template <bool PG, bool DRAY>
__global__ void __launch_bounds__(NTHR, 1) chain_kernel(Weights w, ChainIO io) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* ring = sm + C_RING;
  float* xsA = reinterpret_cast<float*>(sm + C_XS);
  float* gsA = reinterpret_cast<float*>(sm + C_GS);
  float* part = reinterpret_cast<float*>(sm + C_PART);
  float* dbsum = reinterpret_cast<float*>(sm + C_DBSUM);
  float* dBs = reinterpret_cast<float*>(sm + C_DBS);
  float* dwoS = reinterpret_cast<float*>(sm + C_DWO);
  float* dboP = reinterpret_cast<float*>(sm + C_DBOP);
  float* woS = reinterpret_cast<float*>(sm + C_WO);
  float* BpS = reinterpret_cast<float*>(sm + C_BP);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C_BAR);
  uint64_t* empty = full + CSTAGE;
  const int tid = threadIdx.x;
  for (int i = tid; i < 4 * HID; i += NTHR) {
    woS[i] = __bfloat162float(w.Wo[i]);
    dbsum[i] = 0.f;
  }
  for (int i = tid; i < 3 * EMB; i += NTHR) {
    BpS[i] = w.Bp[i];
    dBs[i] = 0.f;
  }
  for (int i = tid; i < (HID + 1) * 4; i += NTHR) dwoS[i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < CSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer: W3, W2, W1 as 4 slices of 32 KB, W0p as 4 of 16 KB
    reg_dealloc<40>();
    if (tid == 256) {
      int it = 0;
      const char* wc = reinterpret_cast<const char*>(w.wc);
      for (long tile = blockIdx.x; tile < io.ntiles; tile += gridDim.x)
        for (int s = 0; s < CHAIN_SLICES; ++s, ++it) {
          if (s < 12)
            ring_produce<CSTAGE>(full, empty, ring, it, wc + (size_t)s * SLICE,
                                 SLICE);
          else
            ring_produce<CSTAGE>(full, empty, ring, it,
                                 wc + 12 * (size_t)SLICE + (s - 12) * (SLICE / 2),
                                 SLICE / 2);
        }
    }
  } else {
    reg_alloc<232>();
    const int g = tid / 128, t = tid & 127, ct = tid;
    const int lane = t & 31, q = lane & 3, warp = t >> 5;
    const int r0 = warp * 16 + (lane >> 2);
    const int wgbar = 1 + g;
    unsigned char* A = sm + C_A + g * ATILE;
    int it = 0;
    for (long tile = blockIdx.x; tile < io.ntiles; tile += gridDim.x) {
      const long p0 = tile * TILE, pb = p0 + g * 64, blk = tile * 2 + g;
      if (PG && t == 0) bulk_wait_read();
      bar_sync(3, 256);       // the last tile is done with every buffer
      if (PG) {
        uint4 hv[ATILE / 16 / 128];
        const uint4* src = reinterpret_cast<const uint4*>(io.h3 + blk * 64 * HID);
#pragma unroll
        for (int i = 0; i < ATILE / 16 / 128; ++i) hv[i] = src[t + 128 * i];
#pragma unroll
        for (int i = 0; i < ATILE / 16 / 128; ++i)
          reinterpret_cast<uint4*>(A)[t + 128 * i] = hv[i];
      }
      if (t < 64) {
        reinterpret_cast<float4*>(xsA)[g * 64 + t] =
            reinterpret_cast<const float4*>(io.x4)[pb + t];
        float4 gv = reinterpret_cast<const float4*>(io.dhead)[pb + t];
        reinterpret_cast<float4*>(gsA)[g * 64 + t] = gv;
        if (PG) {
          // dbo partial of the warp's 32 points (float32, tree order)
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            gv.x += __shfl_xor_sync(0xffffffffu, gv.x, o);
            gv.y += __shfl_xor_sync(0xffffffffu, gv.y, o);
            gv.z += __shfl_xor_sync(0xffffffffu, gv.z, o);
            gv.w += __shfl_xor_sync(0xffffffffu, gv.w, o);
          }
          if (lane == 0) reinterpret_cast<float4*>(dboP)[g * 2 + warp] = gv;
        }
      }
      bar_sync(3, 256);
      if (PG) {
        // dWo[n][c] += h3[m][n] g[m][c] (g rounded to bf16), dbo[c] +=
        // g[m][c] (float32): thread ct owns hidden column n = ct, rows in
        // order
        float4 dwo = reinterpret_cast<float4*>(dwoS)[ct];
        for (int m = 0; m < TILE; ++m) {
          const unsigned char* Am = sm + C_A + (m >> 6) * ATILE;
          const float hv = __bfloat162float(
              *reinterpret_cast<const bf16*>(Am + sw_off(m & 63, ct)));
          const float4 gm = reinterpret_cast<const float4*>(gsA)[m];
          dwo.x += hv * bf16r(gm.x);
          dwo.y += hv * bf16r(gm.y);
          dwo.z += hv * bf16r(gm.z);
          dwo.w += hv * bf16r(gm.w);
        }
        reinterpret_cast<float4*>(dwoS)[ct] = dwo;
        if (ct < 4) {
          float dbo = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) dbo += dboP[i * 4 + ct];
          dwoS[HID * 4 + ct] += dbo;
        }
        bar_sync(3, 256);     // A is overwritten below
      }
      // head backward: dh3 = (bf16(g) @ Wo^T) * (h3 > 0), c in order
      float acc[128];
      {
        const uint4 mk = io.masks[((size_t)3 * io.ntiles * 2 + blk) * 128 + t];
        float gr[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            gr[hf][c] = bf16r(gsA[(g * 64 + r0 + 8 * hf) * 4 + c]);
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 wv = *reinterpret_cast<const float4*>(
                woS + ACC_COL(j, q, e) * 4);
            const float* gg = gr[e >> 1];
            float v = 0.f;
            v += gg[0] * wv.x;
            v += gg[1] * wv.y;
            v += gg[2] * wv.z;
            v += gg[3] * wv.w;
            acc[4 * j + e] = bit(mk, 4 * j + e) ? v : 0.f;
          }
      }
      chain_epilogue<PG>(acc, A, part, dbsum + 3 * HID, io.dh[3], blk, g, t,
                         wgbar);
      // dh_{L-1} = dh_L @ W_L^T * (h_{L-1} > 0), L = 3, 2, 1
#pragma unroll 1
      for (int L = 3; L >= 1; --L) {
        const uint4 mk =
            io.masks[((size_t)(L - 1) * io.ntiles * 2 + blk) * 128 + t];
        for (int s = 0; s < 4; ++s, ++it)
          ring_consume<CSTAGE, 256>(full, empty, ring, it, A + s * CHUNK_B,
                                    acc, s == 0);
        ring_drain<CSTAGE>(empty, it - 1);
        if (PG && t == 0) bulk_wait_read();
        bar_sync(wgbar, 128);
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = bit(mk, i) ? acc[i] : 0.f;
        chain_epilogue<PG>(acc, A, part + ((4 - L) & 1) * 8 * HID,
                           dbsum + (L - 1) * HID, io.dh[L - 1], blk, g, t,
                           wgbar);
      }
      // demb = dh0 @ W0p^T * cos(x . B)   (64 x 128 per warpgroup)
      // (defined before the first product: the asm operands are in-out, so
      // an undefined d would stay live across the whole tile loop)
      float d[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
      for (int s = 0; s < 4; ++s, ++it)
        ring_consume<CSTAGE, 128>(full, empty, ring, it, A + s * CHUNK_B, d,
                                  s == 0);
      ring_drain<CSTAGE>(empty, it - 1);
      const float* xr[2] = {xsA + (g * 64 + r0) * 4, xsA + (g * 64 + r0 + 8) * 4};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[4 * j + e] *= cosf(xdotb(xr[e >> 1], BpS, ACC_COL(j, q, e)));
      if (DRAY) {
        // dx[m][k] = sum_l demb[m][l] Bp[k][l]: own 32 columns in order,
        // then the quad by shfl_xor 1, 2
        float sx[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int k = 0; k < 3; ++k)
              sx[e >> 1][k] += d[4 * j + e] * BpS[k * EMB + ACC_COL(j, q, e)];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            sx[hf][k] += __shfl_xor_sync(0xffffffffu, sx[hf][k], 1);
            sx[hf][k] += __shfl_xor_sync(0xffffffffu, sx[hf][k], 2);
          }
        if (q == 0)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int k = 0; k < 3; ++k)
              io.dx[(pb + r0 + 8 * hf) * 3 + k] = sx[hf][k];
      }
      if (PG) {
        // dB[k][l] += sum_m x[m][k] demb[m][l], rows in order: demb goes
        // to the (now free) A tiles as f32 (64 x 128 per warpgroup, column
        // groups of 8 XOR-swizzled by row against bank conflicts)
        if (t == 0) bulk_wait_read();
        bar_sync(wgbar, 128);
        float* de = reinterpret_cast<float*>(A);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = r0 + 8 * hf;
            *reinterpret_cast<float2*>(de + row * EMB +
                                       ((8 * j + 2 * q) ^ ((row & 7) << 3))) =
                make_float2(d[4 * j + 2 * hf], d[4 * j + 2 * hf + 1]);
          }
        bar_sync(3, 256);
        for (int i = ct; i < 384; i += 256) {
          const int k = i >> 7, l = i & 127;
          float s = 0.f;
#pragma unroll 8
          for (int m = 0; m < TILE; ++m) {
            const float* dem = reinterpret_cast<const float*>(
                sm + C_A + (m >> 6) * ATILE);
            const int row = m & 63;
            s += xsA[m * 4 + k] * dem[row * EMB + (l ^ ((row & 7) << 3))];
          }
          dBs[i] += s;
        }
      }
    }
    if (PG) {
      if (t == 0) bulk_wait_all();
      bar_sync(3, 256);
      float* row = io.small + (long)blockIdx.x * SMALL;
      for (int i = ct; i < 384; i += 256) row[SMALL_B + i] = dBs[i];
      for (int i = ct; i < 4 * HID; i += 256) row[SMALL_BIAS + i] = dbsum[i];
      for (int i = ct; i < (HID + 1) * 4; i += 256) row[SMALL_WO + i] = dwoS[i];
    }
  }
}

// ---- weight gradients: dW_l = in_l^T @ dh_l over the points ------------
// Block (mt, split): output rows [rowoff, rowoff + 128) of layer l (mt 0:
// layer 0; 1-2: layer 1; 3-4: layer 2; 5-6: layer 3), points of 64-point
// blocks [split * nkb / NSPLIT_W, (split + 1) * nkb / NSPLIT_W). Both
// operands are spill blocks, loaded whole by 1-D bulk copies (the A rows
// as one 16 KB piece, dh as 32 KB) into a 4-stage ring and read MN-major.
constexpr int W_STAGE = 4;
constexpr int W_ABYTES = 2 * CHUNK_B;           // 64 points x 128 rows
constexpr int W_STEP = W_ABYTES + ATILE;        // + 64 points x 256 columns
constexpr int W_SMEM = W_STAGE * W_STEP + 2 * W_STAGE * 8 + 1024;

struct WgradIO {
  const bf16* in[4];     // emb, h0, h1, h2 (spill blocks)
  const bf16* dh[4];
  float* wpart;          // (4, NSPLIT_W, 256 * 256)
  long nkb;              // 64-point blocks
};

__global__ void __launch_bounds__(NTHR, 1) wgrad_kernel(WgradIO io) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + W_STAGE * W_STEP);
  uint64_t* empty = full + W_STAGE;
  const int tid = threadIdx.x, mt = blockIdx.x, split = blockIdx.y;
  const int layer = mt == 0 ? 0 : (mt + 1) / 2;
  const int rowoff = mt == 0 ? 0 : ((mt - 1) & 1) * 128;
  const long blockbytes = 64L * (layer == 0 ? EMB : HID) * 2;
  const long kb0 = split * io.nkb / NSPLIT_W;
  const long kb1 = (split + 1) * io.nkb / NSPLIT_W;
  if (tid == 0) {
    for (int s = 0; s < W_STAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= 256) {
    reg_dealloc<40>();
    if (tid == 256) {
      const char* a = reinterpret_cast<const char*>(io.in[layer]) + rowoff * 128;
      const char* b = reinterpret_cast<const char*>(io.dh[layer]);
      int it = 0;
      for (long kb = kb0; kb < kb1; ++kb, ++it) {
        const int st = it % W_STAGE;
        mbar_wait(&empty[st], ((it / W_STAGE) & 1) ^ 1);
        mbar_expect_tx(&full[st], W_STEP);
        unsigned char* dst = sm + st * W_STEP;
        bulk_g2s(dst, a + kb * blockbytes, W_ABYTES, &full[st], l2_normal());
        bulk_g2s(dst + W_ABYTES, b + kb * ATILE, ATILE, &full[st], l2_normal());
      }
    }
  } else {
    reg_alloc<232>();
    const int g = tid / 128, t = tid & 127;
    const int lane = t & 31, q = lane & 3;
    const int r0 = (t >> 5) * 16 + (lane >> 2);
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int it = 0;
    for (long kb = kb0; kb < kb1; ++kb, ++it) {
      const int st = it % W_STAGE;
      mbar_wait(&full[st], (it / W_STAGE) & 1);
      unsigned char* sa = sm + st * W_STEP + g * CHUNK_B;
      unsigned char* sb = sm + st * W_STEP + W_ABYTES;
      wg_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_n256<1, 1>(acc, desc_sw128(sa + k * 2048, CHUNK_B, 1024),
                         desc_sw128(sb + k * 2048, CHUNK_B, 1024), 1);
      wg_commit();
      if (kb > kb0) {
        wg_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % W_STAGE]);
      }
    }
    wg_wait<0>();
    float* out = io.wpart + ((long)layer * NSPLIT_W + split) * HID * HID;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(
            out + (long)(rowoff + g * 64 + r0 + 8 * hf) * HID + 8 * j + 2 * q) =
            make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
  }
}

// ---- workspace and launches (K1, K3, K4) ------------------------------
struct WS {
  float* x4;       // (Ppad, 4): x, y, z, ray depth z
  float* raw;      // (Ppad, 4)
  bf16* emb;       // spill blocks (Ppad x 128), weight-gradient runs only
  bf16* h[4];      // spill blocks (Ppad x 256), weight-gradient runs only
  uint4* masks;    // (4, Ppad / 64, 128)
  float* dhead;    // (Ppad, 4)
  float* gdvec;    // (n, 3)
  float* dx;       // (Ppad, 3)
  bf16* dh[4];     // spill blocks, weight-gradient runs only
  float* small;    // (chain blocks, SMALL)
  float* wpart;    // (4, NSPLIT_W, 256 * 256)
  size_t bytes;
  long Ppad;
};

constexpr int PAD = 1024;    // padded point count is a multiple

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

inline long chain_blocks(long ntiles) {
  return ntiles < num_sms() ? ntiles : num_sms();
}

inline WS carve(char* base, int n, int S2, int SR, int pg) {
  WS w{};
  const long P = (long)n * (S2 + SR);
  w.Ppad = (P + PAD - 1) / PAD * PAD;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off = align256(off + bytes);
    return p;
  };
  w.x4 = reinterpret_cast<float*>(take(w.Ppad * 16));
  w.raw = reinterpret_cast<float*>(take(w.Ppad * 16));
  w.masks = reinterpret_cast<uint4*>(take(w.Ppad * 4 * 32));
  w.dhead = reinterpret_cast<float*>(take(w.Ppad * 16));
  w.gdvec = reinterpret_cast<float*>(take((size_t)n * 12));
  w.dx = reinterpret_cast<float*>(take(w.Ppad * 12));
  if (pg) {
    w.emb = reinterpret_cast<bf16*>(take(w.Ppad * EMB * 2));
    for (int i = 0; i < 4; ++i)
      w.h[i] = reinterpret_cast<bf16*>(take(w.Ppad * HID * 2));
    for (int i = 0; i < 4; ++i)
      w.dh[i] = reinterpret_cast<bf16*>(take(w.Ppad * HID * 2));
    w.small = reinterpret_cast<float*>(
        take((size_t)chain_blocks(w.Ppad / TILE) * SMALL * 4));
    w.wpart = reinterpret_cast<float*>(
        take((size_t)4 * NSPLIT_W * HID * HID * 4));
  }
  w.bytes = off;
  return w;
}

// MODE 1/2's points: the z2 (and SR regulation) points of the n rays,
// into the workspace's x4, raw, masks and (MODE 2) spill blocks
inline FwdIO pass2_io(const WS& ws, const float* rays, const float* z2,
                      const float* treg, const float* bound6, int n, int S2,
                      int SR) {
  FwdIO io{};
  io.rays = rays;
  io.z2 = z2;
  io.treg = treg;
  io.bound6 = bound6;
  io.x4 = ws.x4;
  io.raw = ws.raw;
  io.emb = ws.emb;
  for (int i = 0; i < 4; ++i) io.h[i] = ws.h[i];
  io.masks = ws.masks;
  io.P = (long)n * (S2 + SR);
  io.ntiles = ws.Ppad / TILE;
  io.S2 = S2;
  io.SR = SR;
  return io;
}

template <bool PG, bool DRAY>
cudaError_t launch_chain(const Weights& w, const WS& ws, cudaStream_t st) {
  ChainIO io{ws.x4, ws.dhead, ws.h[3], ws.masks,
             {ws.dh[0], ws.dh[1], ws.dh[2], ws.dh[3]}, ws.dx, ws.small,
             ws.Ppad / TILE};
  cudaError_t e = cudaFuncSetAttribute(chain_kernel<PG, DRAY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C_SMEM);
  if (e != cudaSuccess) return e;
  chain_kernel<PG, DRAY><<<(int)chain_blocks(io.ntiles), NTHR, C_SMEM, st>>>(
      w, io);
  return cudaGetLastError();
}

inline cudaError_t launch_wgrad(const WS& ws, cudaStream_t st) {
  WgradIO io{{ws.emb, ws.h[0], ws.h[1], ws.h[2]},
             {ws.dh[0], ws.dh[1], ws.dh[2], ws.dh[3]}, ws.wpart, ws.Ppad / 64};
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (e != cudaSuccess) return e;
  wgrad_kernel<<<dim3(WG_MTILES, NSPLIT_W), NTHR, W_SMEM, st>>>(io);
  return cudaGetLastError();
}

}  // namespace hop
