// Hopper tile of the iMAP* decoder, for sm_90a: the PTX helpers and the
// forward tile that every kernel of the port runs, K1 (fused_vg.cu), K2
// (p1_sigma.cu), the render megakernel pair K3/K4 (megakernel.cu) and the
// decoder pair K5/K6 (fused_mlp.cu). The backward pieces (dh chain, weight
// gradients, the workspace) are in hopper_bwd.cuh, which only K1, K3/K4
// and K6 include; K2 builds the forward alone.
//
// The TPU kernels are the JAX reference's ops/fused_vg.py:304
// `_make_vg_kernel` (K1), :284 `_make_p1_kernel` (K2), ops/megakernel.py
// :393 / :480 (K3 / K4) and ops/fused_mlp.py:104 / :116 (K5 / K6).
//
// What bounds the work on the H100 (989 TFLOP/s bf16, 3.35 TB/s): the
// decoder is 2 x (93*256 + 3*256*256 + 256*4) = 442,880 FLOP per point and
// pass; a forward that writes only its output (K2: one float, K5: four,
// per point, against 12-36 bytes read) is bound by those operations
// (K5 at the mesher's 500,000-point chunk: 0.224 ms). The spill of the
// backward's runs is reckoned in hopper_bwd.cuh.
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
//    layer instead of h (512 bytes).
//
// Numerics, those of the TPU kernels: x . B is the float32 FMA chain
// fma(x2, B2, fma(x1, B1, x0 * B0)) under -fmad=false, emb = sinf of it,
// rounded to bf16; hidden products bf16 x bf16 with f32 sums; the head
// (256 -> 4) on CUDA cores from the bf16-rounded h3: each thread sums its
// 64 columns in order, then the four threads of a quad add by shfl_xor 1
// then 2, then + bo; sigma is 100 outside the AABB in pass 1 (K2, K3);
// the decoder on arbitrary points (K5, K6) has no sentinel.
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

// m64n8k16: the weight gradients' dWo tile (256 x 4 of it used)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
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

// ---- forward tile (K1-K6) ------------------------------------------------
// MODE 0: pass-1 sigma (K2, K3): points z = 0.01 gt_d (1 - t) + far t,
//         writes sig (100 outside the AABB), nothing else;
// MODE 1: the forward of a backward (K1, K3's pass 2, K4, K6): writes x4,
//         raw and the ReLU bit masks of h0..h3 for points up to Ppad;
// MODE 2: MODE 1 and the bf16 spill of emb and h0..h3 (weight gradients);
// MODE 3: the decoder alone (K5): writes raw for the P real points only.
// Points of MODES 1-3: row p of pts (x, y, z; ray depth 0) when pts is
// set, else the z2 (+ regulation) points of the rays.
struct FwdIO {
  const float* rays;     // (n, 8) [o, d, gt_d, far]
  const float* z2;       // (n, S2)
  const float* treg;     // (n, SR)
  const float* bound6;   // MODE 0
  const float* pts;      // (P, 3), or null
  float* x4;             // (Ppad, 4)
  float* raw;            // (Ppad, 4); MODE 3: (P, 4)
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
    } else if (io.pts) {
      x = io.pts[p * 3];
      y = io.pts[p * 3 + 1];
      zc = io.pts[p * 3 + 2];
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
  if (MODE == 0 && tid < 6) b6[tid] = io.bound6[tid];
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
        if (MODE == 1 || MODE == 2)
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
        if (MODE == 1 || MODE == 2)
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
              } else if (MODE != 3 || p < io.P) {
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

// MODE 3's points: the n rows of pts (n, 3), raw into out (n, 4) (K5)
inline FwdIO points_io(const float* pts, float* out, long n) {
  FwdIO io{};
  io.pts = pts;
  io.raw = out;
  io.P = n;
  io.ntiles = (n + TILE - 1) / TILE;
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

}  // namespace hop
