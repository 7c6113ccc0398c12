// fused_mlp: the iMAP* decoder on arbitrary points (N, 3) -> raw RGBA
// (N, 4), forward and its recompute backward.
//
// Replaces the JAX reference's Pallas TPU kernels ops/fused_mlp.py:104
// `_fwd_kernel` (K5, pallas_call at :172) and :116 `_bwd_kernel` (K6,
// pallas_call at :199), the custom-VJP pair of `fused_imap_mlp`.
//
// K5, mlp_fwd: one block per 64-point tile, the tail tile masked (no
//   padded copy of the input): x . B in float32 FMAs, sin, four bf16
//   tensor-core layers ping-ponging in shared memory, the 4-wide head.
//   Only x (12 bytes per point) and raw (16) touch device memory: at the
//   mesher's 500,000-point chunk one 256-wide bf16 layer would be 256 MB.
// K6, mlp_bwd, given the cotangent g (N, 4):
//   mlp_points<true>  the forward again, tile by tile (nothing is kept from
//                     K5, as the TPU kernel recomputes), writing x, g (zero
//                     rows up to a multiple of 1024 points: a zero
//                     cotangent adds nothing) and the bf16 emb, h0..h3 into
//                     the kernel's own workspace for the chain
//   vg_chain          K1/K4's dh chain (vg_shared.cuh): bf16-rounded
//                     cotangents at every product, as the TPU kernel's
//                     _dot_tn / _dot_nt; dx = demb . B^T and dB = x^T demb
//                     in float32; small sums (dB, biases, head) per block
//   vg_wgrad, reduce_rows  dW_l = in_l^T dh_l as split-K partial tiles,
//                     summed in a fixed order (no atomics: readings are
//                     bit-reproducible run to run); skipped, with the
//                     small sums, when no parameter needs a gradient
//
// Bound on the H100: ~0.44 MFLOP of bf16 products per point forward and
// ~1.33 MFLOP per point for recompute + backward, over 989 TFLOP/s; the
// bytes (28 per point forward, 40 backward) are far below that line. Like
// K2 this first version loads WMMA fragments of the weights from L2 (no
// wgmma/TMA pipeline, no weight residency), so it sits well above the
// bound.
#include "vg_shared.cuh"

namespace {

// SPILL = false (K5): raw (n, 4) -> out. SPILL = true (K6's recompute):
// x4g / dheadg (x and g, zeros past n) and the activations for the chain.
template <bool SPILL>
__global__ void __launch_bounds__(NTHREADS)
mlp_points(Weights w, const float* __restrict__ x, const float* __restrict__ g,
           float* __restrict__ out, float* __restrict__ x4g,
           float* __restrict__ dheadg, bf16* embg, bf16* h0, bf16* h1,
           bf16* h2, bf16* h3, long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  bf16* es = reinterpret_cast<bf16*>(smem + SM_XS);
  bf16* h0s = reinterpret_cast<bf16*>(smem + SM_XS + SM_ES);
  bf16* h1s = reinterpret_cast<bf16*>(smem + SM_XS + SM_ES + SM_H);
  float* stage = reinterpret_cast<float*>(smem + SM_XS + SM_ES + 2 * SM_H);

  const int t = threadIdx.x;
  const long p0 = (long)blockIdx.x * TILE_M;
  if (t < TILE_M) {
    const long p = p0 + t;
    const bool live = p < n;
    for (int k = 0; k < 3; ++k) xs[t * 4 + k] = live ? x[p * 3 + k] : 0.f;
    xs[t * 4 + 3] = 0.f;
    if (SPILL) {
      for (int k = 0; k < 4; ++k) {
        x4g[p * 4 + k] = xs[t * 4 + k];
        dheadg[p * 4 + k] = live ? g[p * 4 + k] : 0.f;
      }
    }
  }
  __syncthreads();
  if (SPILL) {
    embed_tile(xs, w.Bp, es, embg + p0 * EMB);
    __syncthreads();
    bf16* const hg[4] = {h0 + p0 * HID, h1 + p0 * HID, h2 + p0 * HID,
                         h3 + p0 * HID};
    hidden_layers(w, es, h0s, h1s, stage, hg);
  } else {
    embed_tile(xs, w.Bp, es, nullptr);
    __syncthreads();
    hidden_layers(w, es, h0s, h1s, stage, nullptr);
    const long p = p0 + t / 4;                      // 256 = 64 x 4
    if (p < n) out[p * 4 + t % 4] = head_out(w, h1s, t / 4, t % 4);
  }
}

template <bool SPILL>
cudaError_t launch_points(const Weights& w, long ntiles, const float* x,
                          const float* g, float* out, const WS& ws, long n,
                          cudaStream_t stream) {
  if (ntiles > 0x7fffffffL) return cudaErrorInvalidValue;
  CK(cudaFuncSetAttribute(mlp_points<SPILL>,
                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                          SM_FWD));
  mlp_points<SPILL><<<(unsigned)ntiles, NTHREADS, SM_FWD, stream>>>(
      w, x, g, out, ws.x4, ws.dhead, ws.emb, ws.h[0], ws.h[1], ws.h[2],
      ws.h[3], n);
  return cudaGetLastError();
}

}  // namespace

// K5. x (n, 3), out (n, 4), both float32 contiguous.
extern "C" int mlp_fwd(const void* const* wp, const float* x, float* out,
                       long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const WS none{};
  return (int)launch_points<false>(weights_from(wp), (n + TILE_M - 1) / TILE_M,
                                   x, nullptr, out, none, n, stream);
}

extern "C" long long mlp_bwd_workspace_bytes(long long n, int pg) {
  return (long long)carve(nullptr, (int)n, 1, 0, pg).bytes;
}

// K6. g (n, 4); dx (n, 3) written with with_dx, grads (the flat layout of
// fused_vg) with param_grads.
extern "C" int mlp_bwd(const void* const* wp, const float* x, const float* g,
                       void* wsp, float* dx, float* grads, long long n,
                       int param_grads, int with_dx, cudaStream_t stream) {
  if (n <= 0 || n > 0x7fffffffLL || !(param_grads || with_dx))
    return (int)cudaErrorInvalidValue;
  const Weights w = weights_from(wp);
  const WS ws = carve(static_cast<char*>(wsp), (int)n, 1, 0, param_grads);
  CK(launch_points<true>(w, ws.Ppad / TILE_M, x, g, nullptr, ws, n, stream));
  CK(chain_and_wgrad(w, ws, param_grads, with_dx, grads, stream));
  if (with_dx)
    CK(cudaMemcpyAsync(dx, ws.dx, (size_t)n * 12, cudaMemcpyDeviceToDevice,
                       stream));
  return (int)cudaGetLastError();
}
