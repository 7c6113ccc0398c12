// fused_mlp: the iMAP* decoder on arbitrary points (N, 3) -> raw RGBA
// (N, 4), forward and its recompute backward.
//
// Replaces the JAX reference's Pallas TPU kernels ops/fused_mlp.py:104
// `_fwd_kernel` (K5, pallas_call at :172) and :116 `_bwd_kernel` (K6,
// pallas_call at :199), the custom-VJP pair of `fused_imap_mlp`.
//
// Both run on the Hopper tile (hopper_mlp.cuh, hopper_bwd.cuh) that K1-K4
// run, with the caller's points in place of points along rays:
// K5, mlp_fwd: hop::fwd_kernel<3>, persistent over min(tiles, SMs) blocks
//   of 128 points, streaming only the forward weight image wf: x . B in
//   float32 FMAs, sin, four wgmma layers with the activations on chip, the
//   4-wide head on CUDA cores. It reads x (12 bytes per point) and writes
//   raw (16) straight into the caller's (N, 4), only rows below N: no
//   padded copy, no x4, masks or spill.
// K6, mlp_bwd, given the cotangent g (N, 4): hopper_vg.cuh's launch
//   sequence, K1's and K4's, over hop::carve's workspace for N points
//   padded to a multiple of 1024 (nothing is kept from K5: the TPU kernel
//   recomputes too):
//   fwd_kernel<2|1>   the forward over the N points (hop::points_ws_io):
//                     x4 = (x, y, z, 0), raw, the ReLU bit masks and, when
//                     a parameter needs a gradient, the bf16 spill
//   copy              dhead = g; its rows past N stay zero (a zero
//                     cotangent adds nothing)
//   chain_kernel<PG, DX>  the dh chain with bf16-rounded cotangents at
//                     every product (the TPU kernel's _dot_tn / _dot_nt),
//                     dx = demb . B^T per point in float32 (DX), per-block
//                     sums of dB = x^T demb, the bias and head gradients
//                     (PG)
//   wgrad_kernel, reduce_rows  dW_l = in_l^T dh_l as split-K partial tiles,
//                     summed in a fixed order (no atomics: readings are
//                     bit-reproducible run to run); skipped, with the small
//                     sums, when no parameter needs a gradient
//   copy              the first N rows of the per-point dx, with with_dx
//
// Bound on the H100: 442,880 FLOP of bf16 products per point and pass over
// 989 TFLOP/s (K5 at the mesher's 500,000-point chunk 0.224 ms; K6 three
// passes, 0.510 ms at the mapper loss's 379,848 points); the bytes K5 must
// move (28 per point) are far below that line, K6's spill is reckoned in
// hopper_bwd.cuh (~1.02 ms floor for this design with weight gradients).
#include "hopper_vg.cuh"

// K5. x (n, 3), out (n, 4), both float32 contiguous; wp with the forward
// image wf.
extern "C" int mlp_fwd(const void* const* wp, const float* x, float* out,
                       long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  return (int)hop::launch_fwd<3>(hop::weights_from(wp),
                                 hop::points_io(x, out, n), stream);
}

extern "C" long long mlp_bwd_workspace_bytes(long long n, int pg) {
  return (long long)hop::carve(nullptr, (int)n, 1, 0, pg).bytes;
}

// K6. g (n, 4); dx (n, 3) written with with_dx, grads (the flat layout of
// fused_vg) with param_grads; wp with both images, wf and wc.
extern "C" int mlp_bwd(const void* const* wp, const float* x, const float* g,
                       void* wsp, float* dx, float* grads, long long n,
                       int param_grads, int with_dx, cudaStream_t stream) {
  if (n <= 0 || n > 0x7fffffffLL || !(param_grads || with_dx))
    return (int)cudaErrorInvalidValue;
  const hop::WS ws =
      hop::carve(static_cast<char*>(wsp), (int)n, 1, 0, param_grads);
  return (int)vg_sequence(
      hop::weights_from(wp), ws, hop::points_ws_io(ws, x, n), param_grads,
      with_dx, grads,
      [&] {
        return cudaMemcpyAsync(ws.dhead, g, (size_t)n * 16,
                               cudaMemcpyDeviceToDevice, stream);
      },
      [&] {
        return with_dx ? cudaMemcpyAsync(dx, ws.dx, (size_t)n * 12,
                                         cudaMemcpyDeviceToDevice, stream)
                       : cudaSuccess;
      },
      stream);
}
