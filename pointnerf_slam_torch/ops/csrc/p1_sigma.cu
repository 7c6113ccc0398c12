// p1_sigma: pass-1 density at S1 stratified depths per ray.
//
// Replaces the JAX reference's Pallas TPU kernel ops/fused_vg.py:284
// `_make_p1_kernel` (its pallas_call at :533, inside `prepare`).
//
// Per point: z = 0.01*gt_d*(1-t) + far*t with t = s/(S1-1); x = o + d*z;
// emb = sin(x . B) in float32; four bf16 tensor-core layers; sigma column
// of the head; 100 where x lies outside the AABB (strict inequalities).
// The kernel itself (`p1_kernel`) lives in mlp_tile.cuh: the megakernel
// forward (megakernel.cu) runs the same pass first.
//
// Bound on the H100: the work is ~0.42 MFLOP of bf16 products per point
// against 36 bytes of input and 4 of output per point, so it is bound by
// operations (tensor-core rate), not bytes. This first version keeps every
// activation on chip (no spill: the tile's 64 x 256 bf16 layers ping-pong
// in shared memory) and reads the weights from L2 through WMMA fragment
// loads; it does not yet use wgmma/TMA, so it runs well below the
// tensor-core peak.
#include "mlp_tile.cuh"

using namespace mlp;

extern "C" int p1_sigma(const void* const* wp, const float* rays,
                        const float* bound6, float* sig1, int n_rays, int S1,
                        cudaStream_t stream) {
  if (n_rays <= 0) return 0;
  return (int)launch_p1(weights_from(wp), rays, bound6, sig1, n_rays, S1,
                        stream);
}
