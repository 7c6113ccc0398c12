// Ray-level device code shared by the fused value-and-grad kernel
// (fused_vg.cu, K1), the render megakernel pair (megakernel.cu, K3/K4) and
// the decoder pair (fused_mlp.cu, K5/K6): the per-ray composite and its
// hand-written VJP, the per-ray d(loss)/d(o, d) sums, the ordered reduce
// of split-K partials and the flat gradient layout. No decoder tile here:
// every kernel runs the decoder on hopper_mlp.cuh / hopper_bwd.cuh.
//
// Point layout: ray r owns points r * (S2 + SR) + s, s < S2 at z2[r, s],
// then SR regulation points; x4 (P, 4) holds x, y, z and the ray depth z,
// raw (P, 4) the decoder's RGBA, dhead (P, 4) its cotangent.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAXS = 64;             // most merged samples per ray
// the flat gradient buffer: dB (3 x 128) | db0..db3 (4 x 256) | dWo
// (256 x 4) | dbo (4), then the weight matrices W0p (128 x 256), W1..W3
// (256 x 256)
constexpr int SMALL_B = 0, SMALL_BIAS = 384, SMALL_WO = 1408, SMALL_BO = 2432;
constexpr int SMALL = 2436;
constexpr long GRAD_W[4] = {SMALL, SMALL + 128 * 256,
                            SMALL + 128 * 256 + 256 * 256,
                            SMALL + 128 * 256 + 2 * 256 * 256};

#define CK(x)                                   \
  do {                                          \
    cudaError_t e_ = (x);                       \
    if (e_ != cudaSuccess) return e_;           \
  } while (0)

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// strictly inside the AABB b6 = (x0, x1, y0, y1, z0, z1)
__device__ __forceinline__ bool inside(float x, float y, float z,
                                       const float* b6) {
  return x > b6[0] && x < b6[1] && y > b6[2] && y < b6[3] && z > b6[4] &&
         z < b6[5];
}

// ---- per-ray composite and its VJP --------------------------------------
// One ray's S2 samples: alpha, transmittance exp(exclusive sum log v),
// depth, var = sum w (z - depth)^2, colour. Sigma is 100 outside the AABB.
struct RayComp {
  float zs[MAXS], sg[MAXS], al[MAXS], tr[MAXS], vr[MAXS], ex[MAXS];
  bool ins[MAXS];
  float depth, var, col[3];
};

__device__ __forceinline__ void composite_forward(
    RayComp& c, const float* z2r, const float* x4g, const float* rawg,
    long pb, int S2, const float* b6, float dn) {
  for (int s = 0; s < S2; ++s) {
    c.zs[s] = z2r[s];
    const float* xp = x4g + (pb + s) * 4;
    c.ins[s] = inside(xp[0], xp[1], xp[2], b6);
    c.sg[s] = c.ins[s] ? rawg[(pb + s) * 4 + 3] : 100.f;
  }
  float cum = 0.f;
  c.depth = 0.f;
  c.col[0] = c.col[1] = c.col[2] = 0.f;
  for (int s = 0; s < S2; ++s) {
    const float dist = (s < S2 - 1 ? c.zs[s + 1] - c.zs[s] : 1e10f) * dn;
    c.ex[s] = expf(-fmaxf(c.sg[s], 0.f) * dist);
    c.al[s] = 1.f - c.ex[s];
    c.vr[s] = (1.f - c.al[s]) + 1e-10f;
    c.tr[s] = expf(cum);
    cum += logf(fmaxf(c.vr[s], 1e-10f));
    const float wt = c.al[s] * c.tr[s];
    c.depth += wt * c.zs[s];
    for (int k = 0; k < 3; ++k) c.col[k] += wt * rawg[(pb + s) * 4 + k];
  }
  c.var = 0.f;
  for (int s = 0; s < S2; ++s) {
    const float e = c.zs[s] - c.depth;
    c.var += c.al[s] * c.tr[s] * (e * e);
  }
}

// Composite VJP, division-free. With G_s = dL/dw_s
//   = gz * z_s + gcol . rgb_s, then extra(s, G_s) for further terms,
//   dL/dalpha_s = T_s (G_s - c_s R_s),  R_s = sum_{k>s} G_k a_k
//   prod_{s<j<k} v_j  (R_{s-1} = G_s a_s + v_s R_s), where c_s is the
// derivative factor of max(1 - a + 1e-10, 1e-10) (1/2 at its tie a = 1).
// Writes the head cotangents of the S2 points (rgb everywhere, sigma only
// inside the AABB: the sentinel 100 is a constant) and returns
// d(loss)/d||d||.
template <typename Extra>
__device__ __forceinline__ float composite_vjp(
    const RayComp& c, const float* rawg, long pb, int S2, float dn,
    float gz, const float* gcol, float* dhead, Extra extra) {
  float R = 0.f, ddn = 0.f;
  for (int s = S2 - 1; s >= 0; --s) {
    const float* rw = rawg + (pb + s) * 4;
    float G = gz * c.zs[s] + gcol[0] * rw[0] + gcol[1] * rw[1] +
              gcol[2] * rw[2];
    G = extra(s, G);
    const float cs = c.vr[s] > 1e-10f ? 1.f : 0.5f;
    const float dal = c.tr[s] * (G - cs * R);
    R = G * c.al[s] + fmaxf(c.vr[s], 1e-10f) * R;
    const float dz = s < S2 - 1 ? c.zs[s + 1] - c.zs[s] : 1e10f;
    const float q = fmaxf(c.sg[s], 0.f);
    const float rp = c.sg[s] > 0.f ? 1.f : (c.sg[s] == 0.f ? 0.5f : 0.f);
    const float gsig = dal * (dz * dn) * c.ex[s] * rp;
    ddn += dal * q * c.ex[s] * dz;
    const float wt = c.al[s] * c.tr[s];
    float* dh = dhead + (pb + s) * 4;
    dh[0] = gcol[0] * wt;
    dh[1] = gcol[1] * wt;
    dh[2] = gcol[2] * wt;
    dh[3] = c.ins[s] ? gsig : 0.f;
  }
  return ddn;
}

// out[c] = sum_r part[r * stride + c], rows in order (deterministic)
__global__ void reduce_rows(const float* __restrict__ part, int nrows,
                            long stride, int ncols, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncols) return;
  float s = 0.f;
  for (int r = 0; r < nrows; ++r) s += part[r * stride + c];
  out[c] = s;
}

// dray[r] = [sum_s dx, sum_s z dx + gdvec (the ||d|| term), 0, 0]
__global__ void vg_dray(const float* __restrict__ x4g,
                        const float* __restrict__ dxg,
                        const float* __restrict__ gdvec,
                        float* __restrict__ dray, int n, int SP) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
  for (int s = 0; s < SP; ++s) {
    const long p = (long)r * SP + s;
    const float z = x4g[p * 4 + 3];
    for (int k = 0; k < 3; ++k) {
      o[k] += dxg[p * 3 + k];
      d[k] += z * dxg[p * 3 + k];
    }
  }
  float* row = dray + (long)r * 8;
  for (int k = 0; k < 3; ++k) {
    row[k] = o[k];
    row[3 + k] = d[k] + gdvec[r * 3 + k];
  }
  row[6] = 0.f;
  row[7] = 0.f;
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
