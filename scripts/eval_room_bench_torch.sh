#!/bin/bash
# Scores a finished synthetic room run of the PyTorch port with the port's
# own tools (pointnerf_slam_torch/tools; numpy, scipy and the in-repo
# native libraries on the host, no JAX): the same steps as
# scripts/eval_room_bench.sh.
#
#   bash scripts/eval_room_bench_torch.sh <output dir>
#
# Reads <out>/mesh/final_mesh_eval_rec.ply (else the newest *_mesh.ply)
# and the newest <out>/ckpts/*.npz; writes under <out>:
#   room_gt_mesh.ply                   the analytic ground-truth mesh
#   room_gt_mesh_culled.ply            culled to the run's gt frustums
#   room_gt_mesh_culled_pc_unseen.npy  the culled-away vertices (2D
#                                      view rejection)
#   eval_metrics.txt                   ATE RMSE, 3D accuracy / completion,
#                                      2D depth-L1 with and without the
#                                      view rejection
# Environment: PYTHON (default python3), GT_RESOLUTION (default 256),
# N_IMGS (2D views, default 200).
set -eo pipefail
cd "$(dirname "$0")/.."
OUT=${1:-output/Synthetic/room_bench_weak}
PY=${PYTHON:-python3}
RES=${GT_RESOLUTION:-256}
NIMG=${N_IMGS:-200}
if [ -f "$OUT/mesh/final_mesh_eval_rec.ply" ]; then
  REC=$OUT/mesh/final_mesh_eval_rec.ply
else
  REC=$(ls -v "$OUT"/mesh/*_mesh.ply | tail -1)
fi
CKPT=$(ls -v "$OUT"/ckpts/*.npz | tail -1)
echo "rec mesh: $REC  ckpt: $CKPT"

$PY -m pointnerf_slam_torch.tools.make_synthetic_gt_mesh \
    --out "$OUT/room_gt_mesh.ply" --resolution "$RES"

$PY -m pointnerf_slam_torch.tools.cull_mesh "$OUT/room_gt_mesh.ply" \
    --traj "$CKPT" --out "$OUT/room_gt_mesh_culled.ply" --save_unseen_pc

# the trajectory plot needs matplotlib, which the card's machine may lack
PLOT=()
if $PY -c "import matplotlib" 2>/dev/null; then
  PLOT=(--plot "$OUT/ate_traj.png")
fi
{
  echo "== eval_ate ($CKPT) =="
  $PY -m pointnerf_slam_torch.tools.eval_ate "$CKPT" "${PLOT[@]}"
  echo "== eval_recon 3D ($REC vs culled GT) =="
  $PY -m pointnerf_slam_torch.tools.eval_recon --rec_mesh "$REC" \
      --gt_mesh "$OUT/room_gt_mesh_culled.ply" -3d
  echo "== eval_recon 2D depth-L1 (with unseen-view rejection) =="
  $PY -m pointnerf_slam_torch.tools.eval_recon --rec_mesh "$REC" \
      --gt_mesh "$OUT/room_gt_mesh_culled.ply" -2d --n_imgs "$NIMG"
  echo "== eval_recon 2D depth-L1 (rejection DISABLED, for the parity delta) =="
  $PY -m pointnerf_slam_torch.tools.eval_recon --rec_mesh "$REC" \
      --gt_mesh "$OUT/room_gt_mesh_culled.ply" -2d --n_imgs "$NIMG" \
      --no_reject_unseen
} | tee "$OUT/eval_metrics.txt"
