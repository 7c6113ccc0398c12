// The launch sequence that K1 (fused_vg.cu), K4 (megakernel.cu) and K6
// (fused_mlp.cu) share on the Hopper tile: they differ only in the step
// between the forward and the dh chain that writes the head cotangents
// (K1, K4: a per-ray composite kernel; K6: a copy of the caller's), and in
// the last step (K1, K4: per-ray sums of the per-point dx; K6: a copy of
// it), which the caller passes in.
#pragma once

#include "hopper_bwd.cuh"
#include "ray_shared.cuh"

namespace {

// Given the forward's points (`io`, hop::pass2_io or hop::points_ws_io
// over the workspace ws):
//   memset dhead; the forward (MODE 2, with its bf16 spill, when weight
//   gradients are asked for, else MODE 1); cotangents(), which writes the
//   rows of ws.dhead that carry one (and, K1/K4, ws.gdvec) from ws.x4 and
//   ws.raw and returns its error; the dh chain (per-point dx into ws.dx
//   with with_dx); with param_grads the weight-gradient GEMM and the
//   ordered reduces into `grads` (the flat layout, GRAD_W); then last(),
//   which returns its error.
template <typename Cotangents, typename Last>
cudaError_t vg_sequence(const hop::Weights& w, const hop::WS& ws,
                        const hop::FwdIO& io, int param_grads, int with_dx,
                        float* grads, Cotangents cotangents, Last last,
                        cudaStream_t stream) {
  CK(cudaMemsetAsync(ws.dhead, 0, ws.Ppad * 16, stream));
  CK(param_grads ? hop::launch_fwd<2>(w, io, stream)
                 : hop::launch_fwd<1>(w, io, stream));
  CK(cotangents());
  if (param_grads && with_dx)
    CK((hop::launch_chain<true, true>(w, ws, stream)));
  else if (param_grads)
    CK((hop::launch_chain<true, false>(w, ws, stream)));
  else if (with_dx)
    CK((hop::launch_chain<false, true>(w, ws, stream)));
  if (param_grads) {
    CK(hop::launch_wgrad(ws, stream));
    // the chain's rows: dB and db0..db3, then dbo; the GEMM's dWo partials
    const int nb = (int)hop::chain_blocks(ws.Ppad / hop::TILE);
    reduce_rows<<<(hop::CROW_BO + 255) / 256, 256, 0, stream>>>(
        ws.small, nb, hop::CROW, hop::CROW_BO, grads + SMALL_B);
    reduce_rows<<<1, 256, 0, stream>>>(ws.small + hop::CROW_BO, nb, hop::CROW,
                                       4, grads + SMALL_BO);
    reduce_rows<<<(4 * hop::HID + 255) / 256, 256, 0, stream>>>(
        ws.wpo, hop::NSPLIT_O, 4 * hop::HID, 4 * hop::HID, grads + SMALL_WO);
    CK(cudaGetLastError());
    for (int l = 0; l < 4; ++l) {
      const int ncols = (l == 0 ? hop::EMB : hop::HID) * hop::HID;
      reduce_rows<<<(ncols + 255) / 256, 256, 0, stream>>>(
          ws.wpart + (long)l * hop::NSPLIT_W * hop::HID * hop::HID,
          hop::NSPLIT_W, (long)hop::HID * hop::HID, ncols, grads + GRAD_W[l]);
      CK(cudaGetLastError());
    }
  }
  CK(last());
  return cudaGetLastError();
}

// K1's and K4's last step: with_dray the per-ray d(loss)/d(o, d) into
// `dray` (n, 8) from the n rays' S2 + SR points, else zeros there.
inline cudaError_t ray_sums(const hop::WS& ws, const hop::FwdIO& io, int n,
                            int with_dray, float* dray, cudaStream_t stream) {
  if (!with_dray) return cudaMemsetAsync(dray, 0, (size_t)n * 32, stream);
  vg_dray<<<(n + 127) / 128, 128, 0, stream>>>(ws.x4, ws.dx, ws.gdvec, dray,
                                               n, io.S2 + io.SR);
  return cudaGetLastError();
}

}  // namespace
