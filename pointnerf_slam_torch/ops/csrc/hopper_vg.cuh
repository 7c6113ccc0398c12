// The launch sequence that K1 (fused_vg.cu) and K4 (megakernel.cu) share
// on the Hopper tile: they differ only in the per-ray composite kernel
// between the forward and the dh chain, which the caller passes in.
#pragma once

#include "hopper_mlp.cuh"
#include "ray_shared.cuh"

namespace {

// Given the forward's points (`io`, hop::pass2_io over the workspace ws):
//   memset dhead; the forward (MODE 2, with its bf16 spill, when weight
//   gradients are asked for, else MODE 1); composite(), which launches the
//   per-ray kernel writing ws.dhead and ws.gdvec from ws.x4 and ws.raw and
//   returns its launch error; the dh chain; with param_grads the weight-
//   gradient GEMM and the ordered reduces into `grads` (the flat layout,
//   GRAD_W); with_dray the per-ray d(loss)/d(o, d) into `dray` (n, 8),
//   else zeros there.
template <typename Composite>
cudaError_t vg_sequence(const hop::Weights& w, const hop::WS& ws,
                        const hop::FwdIO& io, int n, int param_grads,
                        int with_dray, float* dray, float* grads,
                        Composite composite, cudaStream_t stream) {
  CK(cudaMemsetAsync(ws.dhead, 0, ws.Ppad * 16, stream));
  CK(param_grads ? hop::launch_fwd<2>(w, io, stream)
                 : hop::launch_fwd<1>(w, io, stream));
  CK(composite());
  if (param_grads && with_dray)
    CK((hop::launch_chain<true, true>(w, ws, stream)));
  else if (param_grads)
    CK((hop::launch_chain<true, false>(w, ws, stream)));
  else if (with_dray)
    CK((hop::launch_chain<false, true>(w, ws, stream)));
  if (param_grads) {
    CK(hop::launch_wgrad(ws, stream));
    reduce_rows<<<(SMALL + 255) / 256, 256, 0, stream>>>(
        ws.small, (int)hop::chain_blocks(ws.Ppad / hop::TILE), SMALL, SMALL,
        grads);
    CK(cudaGetLastError());
    for (int l = 0; l < 4; ++l) {
      const int ncols = (l == 0 ? hop::EMB : hop::HID) * hop::HID;
      reduce_rows<<<(ncols + 255) / 256, 256, 0, stream>>>(
          ws.wpart + (long)l * hop::NSPLIT_W * hop::HID * hop::HID,
          hop::NSPLIT_W, (long)hop::HID * hop::HID, ncols, grads + GRAD_W[l]);
      CK(cudaGetLastError());
    }
  }
  if (with_dray) {
    vg_dray<<<(n + 127) / 128, 128, 0, stream>>>(ws.x4, ws.dx, ws.gdvec,
                                                 dray, n, io.S2 + io.SR);
  } else {
    CK(cudaMemsetAsync(dray, 0, (size_t)n * 32, stream));
  }
  return cudaGetLastError();
}

}  // namespace
