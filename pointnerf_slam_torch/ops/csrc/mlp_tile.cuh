// Shared pieces of the iMAP* decoder kernels (p1_sigma.cu, fused_vg.cu,
// megakernel.cu, fused_mlp.cu).
//
// Decoder: emb = sin(x . B) (x . B in float32 FMAs, never TF32/bf16), then
// four 256-wide ReLU layers and a 4-wide RGBA head. Hidden and head
// products take bf16 operands and accumulate in float32 on the tensor
// cores (WMMA 16x16x16), the numerics of the JAX reference's Pallas kernels.
//
// One block owns a tile of TILE_M = 64 points. Activations of the tile
// live in shared memory (bf16, rows padded to avoid bank conflicts); the
// weights (~0.45 MB bf16, more than a block's 227 KB of shared memory)
// are read layer by layer from global memory / L2 straight into WMMA
// fragments. Each warp owns whole 16-column strips of the output, so a
// weight fragment is loaded once and used for all four 16-row tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace mlp {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int TILE_M = 64;      // points per block tile
constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
constexpr int HID = 256;
constexpr int EMB = 128;        // Fourier columns padded 93 -> 128 (zeros)
constexpr int LDH = HID + 8;    // shared-memory row stride, 256-wide bf16
constexpr int LDE = EMB + 8;    // shared-memory row stride, 128-wide bf16

// Weight pointers in the order the Python wrapper passes them:
// Bp (3,128) f32, W0p (128,256), W1..W3 (256,256), Wo (256,4) bf16,
// b0..b3 (256) f32, bo (4) f32.
struct Weights {
  const float* Bp;
  const bf16* W[5];
  const float* b[5];
};

inline Weights weights_from(const void* const* w) {
  Weights r;
  r.Bp = static_cast<const float*>(w[0]);
  for (int i = 0; i < 5; ++i) r.W[i] = static_cast<const bf16*>(w[1 + i]);
  for (int i = 0; i < 5; ++i) r.b[i] = static_cast<const float*>(w[6 + i]);
  return r;
}

// Shared-memory carve-up of one forward tile (bytes, 128-aligned pieces).
constexpr int SM_XS = TILE_M * 4 * 4;                 // x, y, z, ray z (f32)
constexpr int SM_ES = TILE_M * LDE * 2;               // embedding (bf16)
constexpr int SM_H = TILE_M * LDH * 2;                // one hidden layer
constexpr int SM_STAGE = NWARP * 256 * 4;             // per-warp 16x16 f32
constexpr int SM_FWD = SM_XS + SM_ES + 2 * SM_H + SM_STAGE;

// out[64 x N] = A[64 x K] (shared bf16, row stride lda) @ Bmat, where
//   B_COL = false: Bmat is W (K x N) row-major in global memory (forward)
//   B_COL = true:  Bmat is W^T for W (N x K) row-major (backward chain)
// epi(row0, col0, stage) receives each finished 16x16 tile in the warp's
// float32 staging buffer (row-major, stride 16).
template <bool B_COL, typename Epi>
__device__ __forceinline__ void tile_gemm(const bf16* A, int lda,
                                          const bf16* Bg, int K, int N,
                                          float* stage, Epi epi) {
  const int warp = threadIdx.x >> 5;
  using BLayout = typename std::conditional<B_COL, wmma::col_major,
                                            wmma::row_major>::type;
  for (int ct = warp; ct < N / 16; ct += NWARP) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TILE_M / 16];
#pragma unroll
    for (int i = 0; i < TILE_M / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bf;
      if (B_COL)
        wmma::load_matrix_sync(bf, Bg + (size_t)ct * 16 * K + k, K);
      else
        wmma::load_matrix_sync(bf, Bg + (size_t)k * N + ct * 16, N);
#pragma unroll
      for (int i = 0; i < TILE_M / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, A + i * 16 * lda + k, lda);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < TILE_M / 16; ++i) {
      wmma::store_matrix_sync(stage, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      epi(i * 16, ct * 16, stage);
      __syncwarp();
    }
  }
}

// x . Bp[:, l] as fma(x2, B2, fma(x1, B1, x0 * B0)): the order the plain
// versions and XLA's CPU dot use, so the bf16 embedding rounds identically.
__device__ __forceinline__ float xdotb(const float* x, const float* Bp,
                                       int l) {
  return __fmaf_rn(x[2], Bp[2 * EMB + l],
                   __fmaf_rn(x[1], Bp[EMB + l], __fmul_rn(x[0], Bp[l])));
}

// emb[m][l] = sin(x[m] . Bp[:, l]) -> bf16 shared (and global when eg).
__device__ __forceinline__ void embed_tile(const float* xs, const float* Bp,
                                           bf16* es, bf16* eg) {
  for (int e = threadIdx.x; e < TILE_M * EMB; e += NTHREADS) {
    const int m = e / EMB, l = e % EMB;
    const bf16 v = __float2bfloat16(sinf(xdotb(xs + m * 4, Bp, l)));
    es[m * LDE + l] = v;
    if (eg) eg[(size_t)m * EMB + l] = v;
  }
}

// Four hidden layers, ping-ponging between h0s and h1s; the last layer's
// activations end in h1s. hg (optional) receives layer i at hg[i] (global,
// row stride HID). Caller has synchronised after embed_tile.
__device__ __forceinline__ void hidden_layers(const Weights& w, const bf16* es,
                                              bf16* h0s, bf16* h1s,
                                              float* stage_all,
                                              bf16* const* hg) {
  float* stage = stage_all + (threadIdx.x >> 5) * 256;
  const int lane = threadIdx.x & 31;
  const bf16* in = es;
  int lda = LDE, K = EMB;
  bf16* bufs[2] = {h1s, h0s};   // layer 3 (index 3) lands in h1s
  for (int layer = 0; layer < 4; ++layer) {
    bf16* out = bufs[(layer + 1) & 1];
    const float* bias = w.b[layer];
    bf16* g = hg ? hg[layer] : nullptr;
    tile_gemm<false>(in, lda, w.W[layer], K, HID, stage,
                     [&](int r0, int c0, float* st) {
                       for (int j = 0; j < 8; ++j) {
                         const int e = lane + 32 * j;
                         const int r = r0 + e / 16, c = c0 + e % 16;
                         const float v = fmaxf(st[e] + bias[c], 0.f);
                         const bf16 hb = __float2bfloat16(v);
                         out[r * LDH + c] = hb;
                         if (g) g[(size_t)r * HID + c] = hb;
                       }
                     });
    __syncthreads();
    in = out;
    lda = LDH;
    K = HID;
  }
}

// raw[m][c] = bf16(h3[m]) . bf16(Wo[:, c]) + bo[c], float32 sums.
__device__ __forceinline__ float head_out(const Weights& w, const bf16* h3,
                                          int m, int c) {
  float s = 0.f;
  for (int k = 0; k < HID; ++k)
    s += __bfloat162float(h3[m * LDH + k]) * __bfloat162float(w.W[4][k * 4 + c]);
  return s + w.b[4][c];
}

__device__ __forceinline__ bool inside(float x, float y, float z,
                                       const float* b6) {
  return x > b6[0] && x < b6[1] && y > b6[2] && y < b6[3] && z > b6[4] &&
         z < b6[5];
}

// Pass-1 density at S1 stratified depths per ray (K2, also the first step
// of the megakernel forward): z = 0.01*gt_d*(1-t) + far*t, t = s/(S1-1);
// sigma column of the head, 100 outside the AABB. rays: (n, 8)
// [o, d, gt_d, far]; sig1: (n, S1).
__global__ void __launch_bounds__(NTHREADS)
p1_kernel(Weights w, const float* __restrict__ rays,
          const float* __restrict__ bound6, float* __restrict__ sig1,
          int n_rays, int S1) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  bf16* es = reinterpret_cast<bf16*>(smem + SM_XS);
  bf16* h0s = reinterpret_cast<bf16*>(smem + SM_XS + SM_ES);
  bf16* h1s = reinterpret_cast<bf16*>(smem + SM_XS + SM_ES + SM_H);
  float* stage = reinterpret_cast<float*>(smem + SM_XS + SM_ES + 2 * SM_H);
  __shared__ float b6[6];

  const int t = threadIdx.x;
  const long P = (long)n_rays * S1;
  const long p0 = (long)blockIdx.x * TILE_M;
  if (t < 6) b6[t] = bound6[t];
  if (t < TILE_M) {
    const long p = p0 + t;
    float x = 0.f, y = 0.f, zc = 0.f, z = 0.f;
    if (p < P) {
      const float* ray = rays + (p / S1) * 8;
      const float tv = (float)(p % S1) / (float)(S1 - 1);
      z = 0.01f * ray[6] * (1.f - tv) + ray[7] * tv;
      x = ray[0] + ray[3] * z;
      y = ray[1] + ray[4] * z;
      zc = ray[2] + ray[5] * z;
    }
    xs[t * 4 + 0] = x;
    xs[t * 4 + 1] = y;
    xs[t * 4 + 2] = zc;
    xs[t * 4 + 3] = z;
  }
  __syncthreads();
  embed_tile(xs, w.Bp, es, nullptr);
  __syncthreads();
  hidden_layers(w, es, h0s, h1s, stage, nullptr);
  if (t < TILE_M && p0 + t < P) {
    const float s = head_out(w, h1s, t, 3);
    sig1[p0 + t] = inside(xs[t * 4], xs[t * 4 + 1], xs[t * 4 + 2], b6)
                       ? s : 100.f;
  }
}

inline cudaError_t launch_p1(const Weights& w, const float* rays,
                             const float* bound6, float* sig1, int n_rays,
                             int S1, cudaStream_t stream) {
  const long P = (long)n_rays * S1;
  const int grid = (int)((P + TILE_M - 1) / TILE_M);
  cudaError_t e = cudaFuncSetAttribute(
      p1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SM_FWD);
  if (e != cudaSuccess) return e;
  p1_kernel<<<grid, NTHREADS, SM_FWD, stream>>>(w, rays, bound6, sig1,
                                                n_rays, S1);
  return cudaGetLastError();
}

}  // namespace mlp

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
