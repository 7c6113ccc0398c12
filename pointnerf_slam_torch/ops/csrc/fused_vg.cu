// fused_vg: loss value and gradients of the iMAP* mapper / tracker losses.
//
// Replaces the JAX reference's Pallas TPU kernel ops/fused_vg.py:304
// `_make_vg_kernel` (its pallas_call at :571, built by `_make_vg_parts.main`
// :558), both variants: mapper (colour, regulation, termination band,
// weight gradients, no ray gradients without BA) and tracker (ray
// gradients only).
//
// The TPU kernel kept a 128-ray tile's activations (9728 points x
// (4 + 128 + 4*256) values, ~22.6 MB) in VMEM between its forward and
// backward sweeps. A Hopper block has 227 KB of shared memory, so this
// version is a short sequence of kernels that SPILL the bf16 activations
// to device memory instead of recomputing them:
//
//   vg_forward    64-point tiles: x, sin(x.B), 4 bf16 tensor-core layers,
//                 RGBA head; writes x, raw, emb and h0..h3 (bf16)
//   vg_composite  one thread per ray: depth/var/colour, loss, closed-form
//                 cotangents (sign(0) = 0), the composite VJP by hand, the
//                 ||d|| term; writes the (P, 4) head cotangent
//   vg_chain      64-point tiles, grid-stride: dh chain with bf16 operands
//                 and f32 accumulation, ReLU masks from the stored bf16 h,
//                 cos(x.B) re-derived in f32, per-point d(loss)/dx, and
//                 per-block sums of the bias / head / B gradients
//   vg_wgrad      dW_l = in_l^T @ dh_l over all points: split-K partial
//                 64x64 tiles (NSPLIT splits), then a deterministic reduce
//   vg_dray       one thread per ray: d/d(o, d) = sum dx, sum z * dx
//
// All but vg_composite live in vg_shared.cuh, shared with the render
// megakernel's backward (megakernel.cu).
//
// Spilling was chosen over recomputing: it keeps each kernel simple, and
// its traffic (~0.9 GB each way per mapper iteration, ~0.5 ms at
// 3.35 TB/s) is small next to this first version's tensor-core time; all
// cross-block sums are partials plus an ordered reduce, so results are
// deterministic.
//
// Bound on the H100: ~1.3 MFLOP of bf16 products per mapper point (forward,
// dh chain, weight gradients), so the work is bound by operations at the
// 989 TFLOP/s bf16 peak; the spill adds the byte term above. This version
// uses WMMA fragments loaded from L2 (no wgmma/TMA pipeline yet), so it
// sits well above that bound.
#include "vg_shared.cuh"

namespace {

// ---- per ray: composite, loss, cotangents, composite VJP ---------------
__global__ void vg_composite(const float* __restrict__ rays,
                             const float* __restrict__ aux,
                             const float* __restrict__ z2,
                             const float* __restrict__ x4g,
                             const float* __restrict__ rawg,
                             const float* __restrict__ bound6,
                             float* __restrict__ outv,
                             float* __restrict__ dhead,
                             float* __restrict__ gdvec, int n, int S2,
                             int SR, int tracker, int with_color,
                             float w_color, float w_reg, float w_beyond) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float b6[6];
  for (int k = 0; k < 6; ++k) b6[k] = bound6[k];
  const long pb = (long)r * (S2 + SR);
  const float* ray = rays + (long)r * 8;
  const float d0 = ray[3], d1 = ray[4], d2 = ray[5], gtd = ray[6];
  const float dsq = d0 * d0 + d1 * d1 + d2 * d2;
  const float dn = sqrtf(dsq);
  const float dn_eps = sqrtf(dsq + 1e-24f);
  const float ray_w = aux[r * 4 + 3];

  RayComp c;
  composite_forward(c, z2 + (long)r * S2, x4g, rawg, pb, S2, b6, dn);
  const float depth = c.depth, var = c.var;

  // loss and closed-form output cotangents
  const float mask = (gtd > 0.f ? 1.f : 0.f) * ray_w;
  const float ed = gtd - depth;
  float wdep, wcol;
  if (tracker) {
    wdep = mask / sqrtf(var + 1e-10f);   // var is stop-gradient
    wcol = w_color * mask;
  } else {
    wdep = mask;
    wcol = w_color * ray_w;
  }
  float loss = fabsf(ed) * wdep;
  const float gdep = -sgn(ed) * wdep;
  const bool beyond = w_beyond > 0.f;
  auto in_band = [&](int s) {
    return c.zs[s] > gtd - 0.10f && c.zs[s] < gtd + 0.05f;
  };
  if (beyond) {
    float m_in = 0.f;
    for (int s = 0; s < S2; ++s)
      if (in_band(s)) m_in += c.al[s] * c.tr[s];
    loss += w_beyond * (1.f - m_in) * mask;
  }
  float gcol[3] = {0.f, 0.f, 0.f};
  if (with_color) {
    float sabs = 0.f;
    for (int k = 0; k < 3; ++k) {
      const float ec = aux[r * 4 + k] - c.col[k];
      sabs += fabsf(ec);
      gcol[k] = -sgn(ec) * wcol;
    }
    loss += sabs * wcol;
  }
  if (SR > 0) {
    float sabs = 0.f;
    for (int j = 0; j < SR; ++j) {
      const long p = pb + S2 + j;
      const float* xp = x4g + p * 4;
      const bool in = inside(xp[0], xp[1], xp[2], b6);
      const float s = in ? rawg[p * 4 + 3] : 100.f;
      sabs += fabsf(s);
      dhead[p * 4 + 3] = in ? w_reg * sgn(s) * ray_w : 0.f;
    }
    loss += w_reg * sabs * ray_w;
  }
  float* o = outv + (long)r * 8;
  o[0] = loss;
  o[1] = depth;
  o[2] = var;
  o[3] = c.col[0];
  o[4] = c.col[1];
  o[5] = c.col[2];
  o[6] = 0.f;
  o[7] = 0.f;

  // the termination band adds dL/dw_s = -w_beyond * mask in band
  const float ddn = composite_vjp(
      c, rawg, pb, S2, dn, gdep, gcol, dhead, [&](int s, float G) {
        return beyond && in_band(s) ? G + -w_beyond * mask : G;
      });
  gdvec[r * 3 + 0] = ddn * d0 / dn_eps;
  gdvec[r * 3 + 1] = ddn * d1 / dn_eps;
  gdvec[r * 3 + 2] = ddn * d2 / dn_eps;
}

cudaError_t run(const Weights& w, const float* rays, const float* aux,
                const float* treg, const float* z2, const float* bound6,
                const WS& ws, float* outv, float* dray, float* grads, int n,
                int S2, int SR, int tracker, int with_color, int param_grads,
                int with_dray, float w_color, float w_reg, float w_beyond,
                cudaStream_t stream) {
  CK(cudaMemsetAsync(ws.dhead, 0, ws.Ppad * 16, stream));
  CK(launch_forward(true, w, rays, z2, treg, ws, n, S2, SR, stream));
  vg_composite<<<(n + 127) / 128, 128, 0, stream>>>(
      rays, aux, z2, ws.x4, ws.raw, bound6, outv, ws.dhead, ws.gdvec, n, S2,
      SR, tracker, with_color, w_color, w_reg, w_beyond);
  CK(cudaGetLastError());
  return run_backward(w, ws, n, S2 + SR, param_grads, with_dray, dray, grads,
                      stream);
}

}  // namespace

extern "C" long long fused_vg_workspace_bytes(int n, int S2, int SR, int pg) {
  return (long long)carve(nullptr, n, S2, SR, pg).bytes;
}

extern "C" int fused_vg(const void* const* wp, const float* rays,
                        const float* aux, const float* treg, const float* z2,
                        const float* bound6, void* wsp, float* outv,
                        float* dray, float* grads, int n, int S2, int SR,
                        int tracker, int with_color, int param_grads,
                        int with_dray, float w_color, float w_reg,
                        float w_beyond, cudaStream_t stream) {
  if (S2 > MAXS || S2 < 2 || SR == 1 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const WS ws = carve(static_cast<char*>(wsp), n, S2, SR, param_grads);
  return (int)run(weights_from(wp), rays, aux, treg, z2, bound6, ws, outv,
                  dray, grads, n, S2, SR, tracker, with_color, param_grads,
                  with_dray, w_color, w_reg, w_beyond, stream);
}
