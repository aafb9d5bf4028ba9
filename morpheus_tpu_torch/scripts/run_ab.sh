#!/bin/bash
# Quality A/B of the port (the port's copy of scripts/run_ab.sh): exact
# reference semantics (configs/ab_exact.yaml) against the shipped
# approximations (configs/ab_shipped.yaml), each trained by
# `python -m morpheus_tpu_torch` on the card, in workspaces under
# exp/torch/. Prints the final Acc/Comp/depth-L1 of both arms.
#
#   bash morpheus_tpu_torch/scripts/run_ab.sh
#
# MORPHEUS_AB_RESUME=1 keeps the arms' workspaces, so each resumes from
# its newest checkpoint.
#
# The live arm's trainer pid is published in $MORPHEUS_AB_PIDFILE (default
# ${TMPDIR:-/tmp}/ab_run.pid), so that a concurrent
# `python -m morpheus_tpu_torch.bench` can SIGSTOP it (and its ranks) for
# the bench instead of timing steps behind it; the file is removed when the
# arm ends or fails.
set -eu
cd "$(dirname "$0")/../.."
OUT=exp/torch
PIDFILE=${MORPHEUS_AB_PIDFILE:-${TMPDIR:-/tmp}/ab_run.pid}
# arm trainers exit without idling the card behind their detached 3-D
# metric eval (CPU-bound); its rows land in metric_3d.txt when it ends
export MORPHEUS_EVAL_DRAIN_S=${MORPHEUS_EVAL_DRAIN_S:-0}
for arm in ab_exact ab_shipped; do
  if [ "${MORPHEUS_AB_RESUME:-0}" != "1" ]; then
    rm -rf "$OUT/$arm"
  fi
  echo "=== $arm: $(date -u +%FT%TZ)"
  T0=$(date +%s)
  python -m morpheus_tpu_torch --config "configs/$arm.yaml" \
    exp --output "$OUT" &
  echo $! > "$PIDFILE"
  wait $! || { rm -f "$PIDFILE"; echo "$arm FAILED"; exit 1; }
  rm -f "$PIDFILE"
  echo "=== $arm done in $(( $(date +%s) - T0 ))s"
done
echo "--- metric_3d ---"
for arm in ab_exact ab_shipped; do
  echo "[$arm]"; cat "$OUT/$arm/metric_3d.txt" 2>/dev/null || echo missing
  echo -n "depth-L1 mean: "
  cat "$OUT/$arm/depths/depth_error/depthL1_score_mean.txt" 2>/dev/null \
    || find "$OUT/$arm" -name 'depthL1_score_mean.txt' -exec cat {} \;
done
