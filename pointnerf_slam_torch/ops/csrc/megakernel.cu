// megakernel: the full render of a ray batch (forward) and its VJP
// (backward), the two-kernel path the tracker takes when its loss needs
// cross-ray state (tracking.handle_dynamic's median mask) or has no depth
// term, and the mapper's past fused value-and-grad's cover.
//
// Replaces the JAX reference's Pallas TPU kernels ops/megakernel.py:393
// `_make_fwd_kernel` (K3, pallas_call at :632) and :480 `_make_bwd_kernel`
// (K4, pallas_call at :654), the custom-VJP pair of `make_fused_render`.
//
// K3, mk_forward, per ray (rays (n, 8) [o, d, gt_d, far], far already
// clipped to 1.2 * max(gt_d) over the whole batch by the wrapper):
//   fwd_kernel<0>    pass-1 sigma at S1 stratified z: K2's tiles
//                    (hop::pass1_io), so the same sigma bit for bit
//   mk_middle        one thread per ray: compositing weights, the
//                    deterministic inverse CDF (searchsorted 'right' as a
//                    count of cdf <= u, w + 1e-5, denom < 1e-5 -> 1), and a
//                    stable rank sort of the S1 + SI merged z (ties by
//                    original index) -> z2 (n, S2), an output
//   fwd_kernel<1>    pass 2 over the z2 points (and, with_reg, the SR
//                    regulation points): x4 and raw, no activation spill
//   mk_composite     one thread per ray: depth, var, colour; sigma at the
//                    regulation points (100 outside the AABB)
// K4, mk_backward, given the cotangents (gdep, gvar, gcol) (n, 8) and
// gsigr (n, SR): K1's launch sequence (hopper_vg.cuh) with its own
// composite step:
//   fwd_kernel<2|1>  pass 2 recomputed (with the bf16 spill of emb and
//                    h0..h3 only when a parameter needs a gradient)
//   mk_composite_bwd one thread per ray: composite recomputed, then its
//                    VJP including the var term (var = sum w (z - depth)^2
//                    depends on depth and on every w); sigma cotangents
//                    masked to in-AABB points, rgb cotangents everywhere;
//                    regulation sigma cotangents likewise masked
//   chain_kernel<PG, true>, then with weight gradients wgrad_kernel and the
//                    ordered reduce_rows (the tracker skips them), vg_dray
//                    (d/d(o, d) = sum dx, sum z dx, plus the ||d|| term)
//
// The TPU kernels kept a 128-ray tile in VMEM and the backward recomputed
// pass 2 there. Here the forward writes nothing but its outputs (and the
// ReLU bit masks, 32 bytes per point and layer, that MODE 1 keeps for
// K1's chain), and the backward recomputes pass 2: holding a spill from
// the forward to the backward would keep it alive across the loss
// computation for every iteration, and the recompute costs one forward.
//
// Bound on the H100: decoder products, ~0.44 MFLOP per point and pass,
// over the 989 TFLOP/s bf16 peak: K3 runs two passes (S1 + S2 + SR points
// per ray; 0.170 ms at the tracker's 5000 x (32 + 44)), K4 the recompute
// and the dh chain (0.197 ms there), plus the weight gradients when asked
// for; the bytes (rays, z, outputs, masks, the spill) stay below that
// line at 3.35 TB/s. The design is the Hopper tile's (hopper_mlp.cuh):
// persistent 128-point tiles, weights streamed through a shared-memory
// ring by bulk copies, wgmma with the activations on chip; the per-ray
// middle and composites run on CUDA cores, one thread per ray.
#include "hopper_vg.cuh"

namespace {

// ---- per ray: weights, inverse CDF, stable merge sort -> z2 ------------
__global__ void mk_middle(const float* __restrict__ rays,
                          const float* __restrict__ sig1,
                          float* __restrict__ z2, int n, int S1, int SI) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int S2 = S1 + SI, M = S1 - 1;
  const float* ray = rays + (long)r * 8;
  const float d0 = ray[3], d1 = ray[4], d2 = ray[5];
  const float dn = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
  const float gtd = ray[6], far = ray[7];
  float zc[MAXS], w1[MAXS], cdf[MAXS];
  for (int s = 0; s < S1; ++s) {
    const float tv = (float)s / (float)(S1 - 1);
    zc[s] = 0.01f * gtd * (1.f - tv) + far * tv;
  }
  float cum = 0.f;
  for (int s = 0; s < S1; ++s) {
    const float sg = sig1[(long)r * S1 + s];
    const float dist = (s < S1 - 1 ? zc[s + 1] - zc[s] : 1e10f) * dn;
    const float al = 1.f - expf(-fmaxf(sg, 0.f) * dist);
    w1[s] = al * expf(cum);
    cum += logf(fmaxf((1.f - al) + 1e-10f, 1e-10f));
  }
  // pdf over the M - 1 interior weights, cdf (M values, cdf[0] = 0)
  float wsum = 0.f;
  for (int m = 0; m < M - 1; ++m) wsum += w1[m + 1] + 1e-5f;
  cdf[0] = 0.f;
  for (int m = 0; m < M - 1; ++m)
    cdf[m + 1] = cdf[m] + (w1[m + 1] + 1e-5f) / wsum;
  for (int k = 0; k < SI; ++k) {
    const float u = (float)k / (float)(SI - 1);
    int inds = 0;
    for (int m = 0; m < M; ++m) inds += cdf[m] <= u ? 1 : 0;
    const int below = inds - 1 > 0 ? inds - 1 : 0;
    const int above = inds < M - 1 ? inds : M - 1;
    const float cb = cdf[below], ca = cdf[above];
    const float bb = 0.5f * (zc[below + 1] + zc[below]);
    const float ba = 0.5f * (zc[above + 1] + zc[above]);
    float denom = ca - cb;
    denom = denom < 1e-5f ? 1.f : denom;
    const float t = (u - cb) / denom;
    zc[S1 + k] = bb + t * (ba - bb);
  }
  // stable ascending sort: rank_i = #{z_j < z_i} + #{j < i : z_j == z_i}
  float* out = z2 + (long)r * S2;
  for (int i = 0; i < S2; ++i) {
    int rank = 0;
    for (int j = 0; j < S2; ++j)
      rank += (zc[j] < zc[i] || (zc[j] == zc[i] && j < i)) ? 1 : 0;
    out[rank] = zc[i];
  }
}

// ---- per ray: depth, var, colour; regulation sigma ----------------------
__global__ void mk_composite(const float* __restrict__ rays,
                             const float* __restrict__ z2,
                             const float* __restrict__ x4g,
                             const float* __restrict__ rawg,
                             const float* __restrict__ bound6,
                             float* __restrict__ outv,
                             float* __restrict__ sigr, int n, int S2,
                             int SR) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float b6[6];
  for (int k = 0; k < 6; ++k) b6[k] = bound6[k];
  const long pb = (long)r * (S2 + SR);
  const float* ray = rays + (long)r * 8;
  const float dn = sqrtf(ray[3] * ray[3] + ray[4] * ray[4] + ray[5] * ray[5]);
  RayComp c;
  composite_forward(c, z2 + (long)r * S2, x4g, rawg, pb, S2, b6, dn);
  float* o = outv + (long)r * 8;
  o[0] = c.depth;
  o[1] = c.var;
  o[2] = c.col[0];
  o[3] = c.col[1];
  o[4] = c.col[2];
  o[5] = o[6] = o[7] = 0.f;
  for (int j = 0; j < SR; ++j) {
    const long p = pb + S2 + j;
    const float* xp = x4g + p * 4;
    sigr[(long)r * SR + j] =
        inside(xp[0], xp[1], xp[2], b6) ? rawg[p * 4 + 3] : 100.f;
  }
}

// ---- per ray: composite recompute and VJP with the given cotangents ----
__global__ void mk_composite_bwd(const float* __restrict__ rays,
                                 const float* __restrict__ z2,
                                 const float* __restrict__ x4g,
                                 const float* __restrict__ rawg,
                                 const float* __restrict__ bound6,
                                 const float* __restrict__ gsm,
                                 const float* __restrict__ gsr,
                                 float* __restrict__ dhead,
                                 float* __restrict__ gdvec, int n, int S2,
                                 int SR) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float b6[6];
  for (int k = 0; k < 6; ++k) b6[k] = bound6[k];
  const long pb = (long)r * (S2 + SR);
  const float* ray = rays + (long)r * 8;
  const float d0 = ray[3], d1 = ray[4], d2 = ray[5];
  const float dsq = d0 * d0 + d1 * d1 + d2 * d2;
  const float dn = sqrtf(dsq);
  const float dn_eps = sqrtf(dsq + 1e-24f);
  RayComp c;
  composite_forward(c, z2 + (long)r * S2, x4g, rawg, pb, S2, b6, dn);
  const float* g = gsm + (long)r * 8;
  const float gdep = g[0], gvar = g[1];
  const float gcol[3] = {g[2], g[3], g[4]};
  // var through depth: d var / d depth = -2 sum_k w_k (z_k - depth)
  float swe = 0.f;
  for (int s = 0; s < S2; ++s)
    swe += c.al[s] * c.tr[s] * (c.zs[s] - c.depth);
  const float gz = gdep + gvar * (-2.f * swe);
  // var directly: d var / d w_s = (z_s - depth)^2
  const float ddn = composite_vjp(
      c, rawg, pb, S2, dn, gz, gcol, dhead, [&](int s, float G) {
        const float e = c.zs[s] - c.depth;
        return G + gvar * (e * e);
      });
  gdvec[r * 3 + 0] = ddn * d0 / dn_eps;
  gdvec[r * 3 + 1] = ddn * d1 / dn_eps;
  gdvec[r * 3 + 2] = ddn * d2 / dn_eps;
  for (int j = 0; j < SR; ++j) {
    const long p = pb + S2 + j;
    const float* xp = x4g + p * 4;
    dhead[p * 4 + 3] =
        inside(xp[0], xp[1], xp[2], b6) ? gsr[(long)r * SR + j] : 0.f;
  }
}

// K3's workspace: K4's layout without weight gradients (x4, raw, masks;
// hop::carve), then the pass-1 sigma
struct FwdWS {
  hop::WS ws;
  float* sig1;     // (n, S1)
  size_t bytes;
};

FwdWS carve_fwd(char* base, int n, int S1, int S2, int SR) {
  FwdWS f{};
  f.ws = hop::carve(base, n, S2, SR, 0);
  f.sig1 = reinterpret_cast<float*>(base ? base + f.ws.bytes : nullptr);
  f.bytes = f.ws.bytes + hop::align256((size_t)n * S1 * 4);
  return f;
}

cudaError_t forward(const hop::Weights& w, const float* rays,
                    const float* treg, const float* bound6, const FwdWS& fw,
                    float* outv, float* sigr, float* z2, int n, int S1,
                    int SI, int SR, cudaStream_t stream) {
  const int S2 = S1 + SI;
  CK(hop::launch_fwd<0>(w, hop::pass1_io(rays, bound6, fw.sig1, n, S1),
                        stream));
  mk_middle<<<(n + 127) / 128, 128, 0, stream>>>(rays, fw.sig1, z2, n, S1,
                                                 SI);
  CK(cudaGetLastError());
  CK(hop::launch_fwd<1>(
      w, hop::pass2_io(fw.ws, rays, z2, treg, bound6, n, S2, SR), stream));
  mk_composite<<<(n + 127) / 128, 128, 0, stream>>>(
      rays, z2, fw.ws.x4, fw.ws.raw, bound6, outv, sigr, n, S2, SR);
  return cudaGetLastError();
}

cudaError_t backward(const hop::Weights& w, const float* rays,
                     const float* treg, const float* z2, const float* gsm,
                     const float* gsr, const float* bound6,
                     const hop::WS& ws, float* dray, float* grads, int n,
                     int S2, int SR, int param_grads, cudaStream_t stream) {
  return vg_sequence(
      w, ws, hop::pass2_io(ws, rays, z2, treg, bound6, n, S2, SR), n,
      param_grads, 1, dray, grads,
      [&] {
        mk_composite_bwd<<<(n + 127) / 128, 128, 0, stream>>>(
            rays, z2, ws.x4, ws.raw, bound6, gsm, gsr, ws.dhead, ws.gdvec, n,
            S2, SR);
        return cudaGetLastError();
      },
      stream);
}

bool bad_sizes(int n, int S1, int SI, int SR) {
  return n <= 0 || S1 < 3 || SI < 2 || S1 + SI > MAXS || SR == 1;
}

}  // namespace

extern "C" long long mk_forward_workspace_bytes(int n, int S1, int SI,
                                                int SR) {
  return (long long)carve_fwd(nullptr, n, S1, S1 + SI, SR).bytes;
}

// Byte offset of K3's pass-1 sigma (n, S1) f32 in its workspace (a debug
// entry: the card-only tests read it after a launch).
extern "C" long long mk_forward_sig1_offset(int n, int S1, int SI, int SR) {
  return (long long)carve_fwd(nullptr, n, S1, S1 + SI, SR).ws.bytes;
}

extern "C" long long mk_backward_workspace_bytes(int n, int S2, int SR,
                                                 int pg) {
  return (long long)hop::carve(nullptr, n, S2, SR, pg).bytes;
}

// K3. SR = 0 skips the regulation points (with_reg off).
extern "C" int mk_forward(const void* const* wp, const float* rays,
                          const float* treg, const float* bound6, void* wsp,
                          float* outv, float* sigr, float* z2, int n, int S1,
                          int SI, int SR, cudaStream_t stream) {
  if (bad_sizes(n, S1, SI, SR)) return (int)cudaErrorInvalidValue;
  const FwdWS fw = carve_fwd(static_cast<char*>(wsp), n, S1, S1 + SI, SR);
  return (int)forward(hop::weights_from(wp), rays, treg, bound6, fw, outv,
                      sigr, z2, n, S1, SI, SR, stream);
}

// K4. grads (the flat layout of fused_vg) is written only with param_grads.
extern "C" int mk_backward(const void* const* wp, const float* rays,
                           const float* treg, const float* z2,
                           const float* gsm, const float* gsr,
                           const float* bound6, void* wsp, float* dray,
                           float* grads, int n, int S1, int SI, int SR,
                           int param_grads, cudaStream_t stream) {
  if (bad_sizes(n, S1, SI, SR)) return (int)cudaErrorInvalidValue;
  const int S2 = S1 + SI;
  const hop::WS ws = hop::carve(static_cast<char*>(wsp), n, S2, SR,
                                param_grads);
  return (int)backward(hop::weights_from(wp), rays, treg, z2, gsm, gsr,
                       bound6, ws, dray, grads, n, S2, SR, param_grads,
                       stream);
}
