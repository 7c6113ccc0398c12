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
// version is a short sequence of kernels that spill to device memory:
//
//   fwd_kernel    128-point tiles (hopper_mlp.cuh): x, sin(x.B), four
//                 wgmma layers, RGBA head; writes x, raw, the ReLU bit
//                 masks and, with weight gradients, emb and h0..h3 (bf16)
//   vg_composite  one thread per ray: depth/var/colour, loss, closed-form
//                 cotangents (sign(0) = 0), the composite VJP by hand, the
//                 ||d|| term; writes the (P, 4) head cotangent
//   chain_kernel  128-point tiles (hopper_bwd.cuh): dh chain on wgmma with
//                 bf16 cotangents, masks from the bits, cos(x.B) in f32,
//                 per-point d(loss)/dx, per-block bias / bo / B sums and
//                 the bf16(dhead) images; its operands prefetched by the
//                 producer warp, its spills drained by bulk stores behind
//                 the next layer's products
//   wgrad_kernel  dW_l = in_l^T @ dh_l and dWo = h3^T bf16(dhead) on wgmma
//                 over all points: split-K partial tiles (128 x 256; dWo
//                 256 x 8), then the ordered reduce_rows
//   vg_dray       one thread per ray: d/d(o, d) = sum dx, sum z * dx
//
// Bound on the H100 (mapper call, 379,848 points padded to 380,928):
// 0.510 ms of bf16 tensor-core work (forward, dh chain, weight gradients
// at 989 TFLOP/s); the spills' byte floors are 0.276 ms (forward), 0.254
// ms (chain) and 0.497 ms (weight gradients), ~3.4 GB, ~1.03 ms at
// 3.35 TB/s (hopper_bwd.cuh). The design: weights streamed through a
// shared-memory ring by bulk copies, wgmma with activations kept on chip,
// spills and their reloads as whole 32 KB bulk copies, ReLU masks as bits
// (the tracker's chain reads 32 bytes per point and layer), and every
// cross-block sum a partial plus an ordered reduce, so results are
// bit-reproducible. The launch sequence is hopper_vg.cuh's, shared with
// K4 (megakernel.cu) and K6 (fused_mlp.cu); vg_composite, vg_dray and
// reduce_rows build on ray_shared.cuh.
#include "hopper_vg.cuh"

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

cudaError_t run(const hop::Weights& w, const float* rays, const float* aux,
                const float* treg, const float* z2, const float* bound6,
                const hop::WS& ws, float* outv, float* dray, float* grads,
                int n, int S2, int SR, int tracker, int with_color,
                int param_grads, int with_dray, float w_color, float w_reg,
                float w_beyond, cudaStream_t stream) {
  const hop::FwdIO io = hop::pass2_io(ws, rays, z2, treg, n, S2, SR);
  return vg_sequence(
      w, ws, io, param_grads, with_dray, grads,
      [&] {
        vg_composite<<<(n + 127) / 128, 128, 0, stream>>>(
            rays, aux, z2, ws.x4, ws.raw, bound6, outv, ws.dhead, ws.gdvec,
            n, S2, SR, tracker, with_color, w_color, w_reg, w_beyond);
        return cudaGetLastError();
      },
      [&] { return ray_sums(ws, io, n, with_dray, dray, stream); }, stream);
}

// One m64n256k16 x 4 product of the wgmma path on images laid out as the
// kernels lay them out: tn = 0, K-major (A: 64 x 64 chunk, B: the 256 x 64
// forward slice); tn = 1, MN-major (the weight gradients' spill blocks:
// A 64 points x 64 rows, B 64 points x 256 columns). out (64, 256) f32,
// row-major. A debug entry for the card-only tests.
__global__ void __launch_bounds__(128) mma_probe(const uint4* a, const uint4* b,
                                                 float* out, int tn) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hop::align1024(smem_raw);
  unsigned char* sb = sm + hop::CHUNK_B;
  const int t = threadIdx.x;
  for (int i = t; i < hop::CHUNK_B / 16; i += 128)
    reinterpret_cast<uint4*>(sm)[i] = a[i];
  for (int i = t; i < hop::ATILE / 16; i += 128)
    reinterpret_cast<uint4*>(sb)[i] = b[i];
  hop::fence_async_smem();
  __syncthreads();
  float acc[128];
  hop::wg_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (tn)
      hop::wgmma_n256<1, 1>(acc, hop::desc_sw128(sm + k * 2048, hop::CHUNK_B, 1024),
                            hop::desc_sw128(sb + k * 2048, hop::CHUNK_B, 1024),
                            k > 0);
    else
      hop::wgmma_n256<0, 0>(acc, hop::desc_sw128(sm + k * 32, 16, 1024),
                            hop::desc_sw128(sb + k * 32, 16, 1024), k > 0);
  }
  hop::wg_commit();
  hop::wg_wait<0>();
  const int lane = t & 31, q = lane & 3, r0 = (t >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 128; ++i)
    out[ACC_ROW(r0, i & 3) * 256 + ACC_COL(i >> 2, q, i & 3)] = acc[i];
}

// Counts the floats (every bit pattern, both NaN counting as equal) where
// the chain's cosine (hopper_bwd.cuh chain_cos) differs from cosf. A debug
// entry for the card-only tests.
__global__ void cos_check(unsigned long long* mismatches) {
  unsigned long long n = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * blockDim.x) {
    float a[1] = {__uint_as_float((unsigned)i)};
    const float ref = cosf(a[0]);
    hop::chain_cos(a);
    if (__float_as_uint(a[0]) != __float_as_uint(ref) &&
        !(a[0] != a[0] && ref != ref))
      ++n;
  }
  if (n) atomicAdd(mismatches, n);
}

}  // namespace

extern "C" long long fused_vg_workspace_bytes(int n, int S2, int SR, int pg) {
  return (long long)hop::carve(nullptr, n, S2, SR, pg).bytes;
}

// Byte offset of the forward's x4 (which = 0) or raw (which = 1), both
// (Ppad, 4) f32, in K1's workspace (a debug entry: the card-only tests
// read them after a launch).
extern "C" long long fused_vg_ws_offset(int n, int S2, int SR, int pg,
                                        int which) {
  char* const base = reinterpret_cast<char*>(uintptr_t(1) << 20);
  const hop::WS ws = hop::carve(base, n, S2, SR, pg);
  return (long long)(reinterpret_cast<char*>(which ? ws.raw : ws.x4) - base);
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
  const hop::WS ws = hop::carve(static_cast<char*>(wsp), n, S2, SR, param_grads);
  return (int)run(hop::weights_from(wp), rays, aux, treg, z2, bound6, ws,
                  outv, dray, grads, n, S2, SR, tracker, with_color,
                  param_grads, with_dray, w_color, w_reg, w_beyond, stream);
}

extern "C" int hopper_mma_probe(const void* a, const void* b, float* out,
                                int tn, cudaStream_t stream) {
  const int smem = hop::CHUNK_B + hop::ATILE + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      mma_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  mma_probe<<<1, 128, smem, stream>>>(static_cast<const uint4*>(a),
                                      static_cast<const uint4*>(b), out, tn);
  return (int)cudaGetLastError();
}

extern "C" int hopper_cos_check(unsigned long long* mismatches,
                                cudaStream_t stream) {
  cos_check<<<4 * hop::num_sms(), 256, 0, stream>>>(mismatches);
  return (int)cudaGetLastError();
}
