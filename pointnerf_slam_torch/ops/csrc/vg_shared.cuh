// Device code shared by the fused value-and-grad kernel (fused_vg.cu, K1)
// and the render megakernel pair (megakernel.cu, K3/K4), whose chain and
// weight gradients the decoder backward (fused_mlp.cu, K6) also runs: the
// forward over
// the merged z2 (and regulation) points with its optional bf16 activation
// spill, the per-ray composite and its hand-written VJP, the dh chain over
// the spilled activations, the split-K weight gradients with their ordered
// reduce, and the per-ray d(loss)/d(o, d) sums.
//
// Point layout: ray r owns points r * (S2 + SR) + s, s < S2 at z2[r, s],
// then SR regulation points; the padded point count Ppad is a multiple of
// CHUNK so every 64-point tile and every weight-gradient split is full.
#pragma once

#include "mlp_tile.cuh"

namespace {

using namespace mlp;

constexpr int MAXS = 64;             // most merged samples per ray
constexpr int CHUNK = 1024;          // padded point count is a multiple
constexpr int NSPLIT = 16;           // K splits of the weight gradients
constexpr int CHAIN_BLOCKS = 264;    // chain grid (2 blocks x 132 SMs)
constexpr int WTILE = 64;            // weight-gradient output tile
// small per-block gradient sums, in the order of the flat gradient
// buffer: dB (3 x 128) | db0..db3 (4 x 256) | dWo (256 x 4) | dbo (4)
constexpr int SMALL_B = 0, SMALL_BIAS = 384, SMALL_WO = 1408, SMALL_BO = 2432;
constexpr int SMALL = 2436;
constexpr long GRAD_W[4] = {SMALL, SMALL + EMB * HID,
                            SMALL + EMB * HID + HID * HID,
                            SMALL + EMB * HID + 2 * HID * HID};
constexpr int LDD = 132;             // f32 row stride of demb in the chain
constexpr int SM_DH4 = TILE_M * 4 * 4;
constexpr int SM_DBSUM = 4 * HID * 4;
constexpr int SM_DBP = 384 * 4;
constexpr int SM_CHAIN =
    2 * SM_H + SM_XS + SM_DH4 + SM_STAGE + SM_DBSUM + SM_DBP;

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

struct WS {
  float* x4;       // (Ppad, 4): x, y, z, ray depth z
  float* raw;      // (Ppad, 4)
  bf16* emb;       // (Ppad, 128)
  bf16* h[4];      // (Ppad, 256)
  float* dhead;    // (Ppad, 4)
  float* gdvec;    // (n, 3)
  float* dx;       // (Ppad, 3)
  bf16* dh[4];     // (Ppad, 256), weight-gradient runs only
  float* small;    // (CHAIN_BLOCKS, SMALL)
  float* wpart;    // (4, NSPLIT, 256 * 256)
  size_t bytes;
  long Ppad;
};

size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

long padded_points(int n, int S2, int SR) {
  const long P = (long)n * (S2 + SR);
  return (P + CHUNK - 1) / CHUNK * CHUNK;
}

WS carve(char* base, int n, int S2, int SR, int pg) {
  WS w{};
  w.Ppad = padded_points(n, S2, SR);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off = align256(off + bytes);
    return p;
  };
  w.x4 = reinterpret_cast<float*>(take(w.Ppad * 16));
  w.raw = reinterpret_cast<float*>(take(w.Ppad * 16));
  w.emb = reinterpret_cast<bf16*>(take(w.Ppad * EMB * 2));
  for (int i = 0; i < 4; ++i)
    w.h[i] = reinterpret_cast<bf16*>(take(w.Ppad * HID * 2));
  w.dhead = reinterpret_cast<float*>(take(w.Ppad * 16));
  w.gdvec = reinterpret_cast<float*>(take((size_t)n * 12));
  w.dx = reinterpret_cast<float*>(take(w.Ppad * 12));
  if (pg) {
    for (int i = 0; i < 4; ++i)
      w.dh[i] = reinterpret_cast<bf16*>(take(w.Ppad * HID * 2));
    w.small = reinterpret_cast<float*>(take((size_t)CHAIN_BLOCKS * SMALL * 4));
    w.wpart = reinterpret_cast<float*>(
        take((size_t)4 * NSPLIT * HID * HID * 4));
  }
  w.bytes = off;
  return w;
}

// ---- forward over the z2 (and regulation) points ------------------------
// SPILL: also write the bf16 embedding and hidden activations (emb, h0..h3)
// for the backward kernels; without it only x4 and raw leave the block.
template <bool SPILL>
__global__ void __launch_bounds__(NTHREADS)
vg_forward(Weights w, const float* __restrict__ rays,
           const float* __restrict__ z2, const float* __restrict__ treg,
           float* __restrict__ x4g, float* __restrict__ rawg,
           bf16* __restrict__ embg, bf16* h0, bf16* h1, bf16* h2, bf16* h3,
           int n, int S2, int SR) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  bf16* es = reinterpret_cast<bf16*>(smem + SM_XS);
  bf16* h0s = reinterpret_cast<bf16*>(smem + SM_XS + SM_ES);
  bf16* h1s = reinterpret_cast<bf16*>(smem + SM_XS + SM_ES + SM_H);
  float* stage = reinterpret_cast<float*>(smem + SM_XS + SM_ES + 2 * SM_H);

  const int t = threadIdx.x;
  const int SP = S2 + SR;
  const long P = (long)n * SP;
  const long p0 = (long)blockIdx.x * TILE_M;
  if (t < TILE_M) {
    const long p = p0 + t;
    float x = 0.f, y = 0.f, zc = 0.f, z = 0.f;
    if (p < P) {
      const long r = p / SP;
      const int s = (int)(p % SP);
      const float* ray = rays + r * 8;
      if (s < S2) {
        z = z2[r * S2 + s];
      } else {
        // stratified-perturbed regulation depth over [0, 0.85 gt_d]
        const int j = s - S2;
        const float g = 0.85f * ray[6];
        auto base = [&](int k) { return g * ((float)k / (float)(SR - 1)); };
        const float lo = j > 0 ? 0.5f * (base(j) + base(j - 1)) : base(0);
        const float hi =
            j < SR - 1 ? 0.5f * (base(j + 1) + base(j)) : base(SR - 1);
        z = lo + (hi - lo) * treg[r * SR + j];
      }
      x = ray[0] + ray[3] * z;
      y = ray[1] + ray[4] * z;
      zc = ray[2] + ray[5] * z;
    }
    xs[t * 4 + 0] = x;
    xs[t * 4 + 1] = y;
    xs[t * 4 + 2] = zc;
    xs[t * 4 + 3] = z;
    x4g[(p0 + t) * 4 + 0] = x;
    x4g[(p0 + t) * 4 + 1] = y;
    x4g[(p0 + t) * 4 + 2] = zc;
    x4g[(p0 + t) * 4 + 3] = z;
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
  }
  rawg[p0 * 4 + t] = head_out(w, h1s, t / 4, t % 4);   // 256 = 64 x 4
}

inline cudaError_t launch_forward(bool spill, const Weights& w,
                                  const float* rays, const float* z2,
                                  const float* treg, const WS& ws, int n,
                                  int S2, int SR, cudaStream_t stream) {
  const int ntiles = (int)(ws.Ppad / TILE_M);
  auto kern = spill ? vg_forward<true> : vg_forward<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SM_FWD);
  if (e != cudaSuccess) return e;
  kern<<<ntiles, NTHREADS, SM_FWD, stream>>>(
      w, rays, z2, treg, ws.x4, ws.raw, ws.emb, ws.h[0], ws.h[1], ws.h[2],
      ws.h[3], n, S2, SR);
  return cudaGetLastError();
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

// ---- dh chain over stored activations ----------------------------------
template <bool PG, bool DRAY>
__global__ void __launch_bounds__(NTHREADS)
vg_chain(Weights w, const float* __restrict__ x4g,
         const float* __restrict__ dheadg, const bf16* h0, const bf16* h1,
         const bf16* h2, const bf16* h3, bf16* dh0, bf16* dh1, bf16* dh2,
         bf16* dh3, float* __restrict__ dxg, float* __restrict__ smallg,
         int ntiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* dA = reinterpret_cast<bf16*>(smem);
  bf16* dB = reinterpret_cast<bf16*>(smem + SM_H);
  float* xs = reinterpret_cast<float*>(smem + 2 * SM_H);
  float* dh4 = reinterpret_cast<float*>(smem + 2 * SM_H + SM_XS);
  float* stage_all =
      reinterpret_cast<float*>(smem + 2 * SM_H + SM_XS + SM_DH4);
  float* dbsum = reinterpret_cast<float*>(smem + 2 * SM_H + SM_XS + SM_DH4 +
                                          SM_STAGE);
  float* dBsum = dbsum + 4 * HID;
  float* dembs = reinterpret_cast<float*>(dA);   // reuses dA after dh0

  const int t = threadIdx.x, lane = t & 31;
  float* stage = stage_all + (t >> 5) * 256;
  const bf16* hs[4] = {h0, h1, h2, h3};
  bf16* dhs[4] = {dh0, dh1, dh2, dh3};
  float wo[4];
  for (int c = 0; c < 4; ++c) wo[c] = __bfloat162float(w.W[4][t * 4 + c]);
  float dwo[4] = {0.f, 0.f, 0.f, 0.f}, dbo = 0.f;
  if (PG) {
    for (int e = t; e < 4 * HID + 384; e += NTHREADS) dbsum[e] = 0.f;
  }
  __syncthreads();

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long p0 = (long)tile * TILE_M;
    if (t < TILE_M) {
      for (int k = 0; k < 4; ++k) {
        xs[t * 4 + k] = x4g[(p0 + t) * 4 + k];
        dh4[t * 4 + k] = dheadg[(p0 + t) * 4 + k];
      }
    }
    __syncthreads();
    // head backward: thread t owns hidden column n = t
    {
      const int nc = t;
      float colsum = 0.f;
      for (int m = 0; m < TILE_M; ++m) {
        const float h3v = __bfloat162float(h3[(p0 + m) * HID + nc]);
        float v = 0.f;
        for (int c = 0; c < 4; ++c) {
          const float g = bf16r(dh4[m * 4 + c]);
          v += g * wo[c];
          if (PG) dwo[c] += h3v * g;
        }
        v = h3v > 0.f ? v : 0.f;
        colsum += v;
        const bf16 vb = __float2bfloat16(v);
        dA[m * LDH + nc] = vb;
        if (PG) dh3[(p0 + m) * HID + nc] = vb;
      }
      if (PG) {
        dbsum[3 * HID + nc] += colsum;
        if (t < 4)
          for (int m = 0; m < TILE_M; ++m) dbo += dh4[m * 4 + t];
      }
    }
    __syncthreads();
    // dh_{L-1} = dh_L @ W_L^T * (h_{L-1} > 0), L = 3, 2, 1
    bf16* bufs[2] = {dA, dB};
    for (int L = 3; L >= 1; --L) {
      const bf16* in = bufs[(3 - L) & 1];
      bf16* out = bufs[(4 - L) & 1];
      const bf16* hm = hs[L - 1] + p0 * HID;
      bf16* dst = PG ? dhs[L - 1] + p0 * HID : nullptr;
      float* bsum = dbsum + (L - 1) * HID;
      tile_gemm<true>(in, LDH, w.W[L], HID, HID, stage,
                      [&](int r0, int c0, float* st) {
                        for (int j = 0; j < 8; ++j) {
                          const int e = lane + 32 * j;
                          const int rr = r0 + e / 16, cc = c0 + e % 16;
                          const float hv =
                              __bfloat162float(hm[(long)rr * HID + cc]);
                          const float v = hv > 0.f ? st[e] : 0.f;
                          st[e] = v;
                          const bf16 vb = __float2bfloat16(v);
                          out[rr * LDH + cc] = vb;
                          if (PG) dst[(long)rr * HID + cc] = vb;
                        }
                        if (PG) {
                          __syncwarp();
                          if (lane < 16) {
                            float s = 0.f;
                            for (int q = 0; q < 16; ++q) s += st[q * 16 + lane];
                            bsum[c0 + lane] += s;
                          }
                        }
                      });
      __syncthreads();
    }
    // dh0 is in dB. demb = dh0 @ W0p^T * cos(x . Bp) -> dembs (f32 on dA)
    tile_gemm<true>(dB, LDH, w.W[0], HID, EMB, stage,
                    [&](int r0, int c0, float* st) {
                      for (int j = 0; j < 8; ++j) {
                        const int e = lane + 32 * j;
                        const int rr = r0 + e / 16, cc = c0 + e % 16;
                        dembs[rr * LDD + cc] =
                            st[e] * cosf(xdotb(xs + rr * 4, w.Bp, cc));
                      }
                    });
    __syncthreads();
    if (DRAY && t < TILE_M * 3) {
      const int m = t / 3, k = t % 3;
      float s = 0.f;
      for (int l = 0; l < EMB; ++l) s += dembs[m * LDD + l] * w.Bp[k * EMB + l];
      dxg[(p0 + m) * 3 + k] = s;
    }
    if (PG) {
      for (int e = t; e < 384; e += NTHREADS) {
        const int k = e / EMB, l = e % EMB;
        float s = 0.f;
        for (int m = 0; m < TILE_M; ++m) s += xs[m * 4 + k] * dembs[m * LDD + l];
        dBsum[e] += s;
      }
    }
    __syncthreads();
  }
  if (PG) {
    float* row = smallg + (long)blockIdx.x * SMALL;
    for (int e = t; e < 384; e += NTHREADS) row[SMALL_B + e] = dBsum[e];
    for (int e = t; e < 4 * HID; e += NTHREADS) row[SMALL_BIAS + e] = dbsum[e];
    for (int c = 0; c < 4; ++c) row[SMALL_WO + t * 4 + c] = dwo[c];
    if (t < 4) row[SMALL_BO + t] = dbo;
  }
}

// ---- weight gradients: dW_l = in_l^T @ dh_l, split-K partial tiles ------
__global__ void __launch_bounds__(128)
vg_wgrad(const bf16* emb, const bf16* h0, const bf16* h1, const bf16* h2,
         const bf16* dh0, const bf16* dh1, const bf16* dh2, const bf16* dh3,
         float* __restrict__ wpart, long Ppad) {
  constexpr int LDS = WTILE + 8;
  __shared__ __align__(128) bf16 As[32 * LDS];
  __shared__ __align__(128) bf16 Bs[32 * LDS];
  const int layer = blockIdx.z, split = blockIdx.y;
  const int ti = blockIdx.x / 4, tj = blockIdx.x % 4;
  const int rows = layer == 0 ? EMB : HID;
  if (ti * WTILE >= rows) return;
  const bf16* ins[4] = {emb, h0, h1, h2};
  const bf16* dhs[4] = {dh0, dh1, dh2, dh3};
  const bf16* src = ins[layer];
  const bf16* dst = dhs[layer];
  const int lds = rows;
  const long chunk = Ppad / NSPLIT;
  const long pbeg = split * chunk;
  const int t = threadIdx.x, warp = t >> 5;
  const int wi = warp / 2, wj = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (long kb = pbeg; kb < pbeg + chunk; kb += 32) {
    for (int v = t; v < 256; v += 128) {
      const int row = v / 8, seg = v % 8;
      *reinterpret_cast<uint4*>(&As[row * LDS + seg * 8]) =
          *reinterpret_cast<const uint4*>(
              &src[(kb + row) * lds + ti * WTILE + seg * 8]);
      *reinterpret_cast<uint4*>(&Bs[row * LDS + seg * 8]) =
          *reinterpret_cast<const uint4*>(
              &dst[(kb + row) * HID + tj * WTILE + seg * 8]);
    }
    __syncthreads();
    for (int kk = 0; kk < 32; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[kk * LDS + wi * 32 + i * 16], LDS);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], &Bs[kk * LDS + wj * 32 + j * 16], LDS);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = wpart + ((long)layer * NSPLIT + split) * HID * HID;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          out + (long)(ti * WTILE + wi * 32 + i * 16) * HID + tj * WTILE +
              wj * 32 + j * 16,
          acc[i][j], HID, wmma::mem_row_major);
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

template <bool PG, bool DRAY>
cudaError_t launch_chain(const Weights& w, const WS& ws, int ntiles,
                         int nblk, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      vg_chain<PG, DRAY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SM_CHAIN);
  if (e != cudaSuccess) return e;
  vg_chain<PG, DRAY><<<nblk, NTHREADS, SM_CHAIN, stream>>>(
      w, ws.x4, ws.dhead, ws.h[0], ws.h[1], ws.h[2], ws.h[3], ws.dh[0],
      ws.dh[1], ws.dh[2], ws.dh[3], ws.dx, ws.small, ntiles);
  return cudaGetLastError();
}

#define CK(x)                                   \
  do {                                          \
    cudaError_t e_ = (x);                       \
    if (e_ != cudaSuccess) return e_;           \
  } while (0)

// The dh chain over the spilled activations once the head cotangents
// (ws.dhead) are written: per-point dx into ws.dx (with_dx), then
// (param_grads) the weight gradients into `grads`.
inline cudaError_t chain_and_wgrad(const Weights& w, const WS& ws,
                                   int param_grads, int with_dx,
                                   float* grads, cudaStream_t stream) {
  const int ntiles = (int)(ws.Ppad / TILE_M);
  const int nblk = ntiles < CHAIN_BLOCKS ? ntiles : CHAIN_BLOCKS;
  if (param_grads && with_dx)
    CK((launch_chain<true, true>(w, ws, ntiles, nblk, stream)));
  else if (param_grads)
    CK((launch_chain<true, false>(w, ws, ntiles, nblk, stream)));
  else if (with_dx)
    CK((launch_chain<false, true>(w, ws, ntiles, nblk, stream)));

  if (param_grads) {
    vg_wgrad<<<dim3(16, NSPLIT, 4), 128, 0, stream>>>(
        ws.emb, ws.h[0], ws.h[1], ws.h[2], ws.dh[0], ws.dh[1], ws.dh[2],
        ws.dh[3], ws.wpart, ws.Ppad);
    CK(cudaGetLastError());
    reduce_rows<<<(SMALL + 255) / 256, 256, 0, stream>>>(
        ws.small, nblk, SMALL, SMALL, grads);
    CK(cudaGetLastError());
    for (int l = 0; l < 4; ++l) {
      const int ncols = (l == 0 ? EMB : HID) * HID;
      reduce_rows<<<(ncols + 255) / 256, 256, 0, stream>>>(
          ws.wpart + (long)l * NSPLIT * HID * HID, NSPLIT, (long)HID * HID,
          ncols, grads + GRAD_W[l]);
      CK(cudaGetLastError());
    }
  }
  return cudaSuccess;
}

// Everything after the head cotangents (ws.dhead, ws.gdvec) are written:
// chain_and_wgrad, then (with_dray) d(loss)/d(rays) into `dray` (zeros
// without).
inline cudaError_t run_backward(const Weights& w, const WS& ws, int n,
                                int SP, int param_grads, int with_dray,
                                float* dray, float* grads,
                                cudaStream_t stream) {
  CK(chain_and_wgrad(w, ws, param_grads, with_dray, grads, stream));
  if (with_dray) {
    vg_dray<<<(n + 127) / 128, 128, 0, stream>>>(ws.x4, ws.dx, ws.gdvec,
                                                 dray, n, SP);
  } else {
    CK(cudaMemsetAsync(dray, 0, (size_t)n * 32, stream));
  }
  return cudaGetLastError();
}

}  // namespace
