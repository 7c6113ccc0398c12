// WMMA device code of the decoder backward (fused_mlp.cu, K6): the dh
// chain over spilled bf16 activations and the split-K weight gradients
// with their ordered reduce, on mlp_tile.cuh's 64-point tile. K1-K4 run
// the Hopper tile (hopper_mlp.cuh) instead; the ray-level helpers all of
// them share are in ray_shared.cuh.
//
// Point layout: as ray_shared.cuh; the padded point count Ppad is a
// multiple of CHUNK so every 64-point tile and every weight-gradient split
// is full.
#pragma once

#include "mlp_tile.cuh"
#include "ray_shared.cuh"

namespace {

using namespace mlp;

constexpr int CHUNK = 1024;          // padded point count is a multiple
constexpr int NSPLIT = 16;           // K splits of the weight gradients
constexpr int CHAIN_BLOCKS = 264;    // chain grid (2 blocks x 132 SMs)
constexpr int WTILE = 64;            // weight-gradient output tile
constexpr int LDD = 132;             // f32 row stride of demb in the chain
constexpr int SM_DH4 = TILE_M * 4 * 4;
constexpr int SM_DBSUM = 4 * HID * 4;
constexpr int SM_DBP = 384 * 4;
constexpr int SM_CHAIN =
    2 * SM_H + SM_XS + SM_DH4 + SM_STAGE + SM_DBSUM + SM_DBP;

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

}  // namespace
