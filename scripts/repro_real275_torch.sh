#!/usr/bin/env bash
# One-command released-checkpoint reproduction on NOCS REAL275, on the port
# (scripts/repro_real275.sh step for step):
#
#   scripts/repro_real275_torch.sh [DATA_ROOT] [OUT_DIR] [args...]
#
# Steps: asset check (fetch_assets) -> a conversion smoke of the .pth into the
# port's checkpoint layout -> full-split eval of the .pth with the SPD initial
# poses (test_catre_torch.sh; args, e.g. --device cpu, go to it) -> the
# per-iteration metric tables in OUT_DIR. If CATRE_REF_SUMMARY_JSON points at
# a json of reference-regenerated numbers ({"IoU75": .., "re5te2": ..}, the
# printed table names), the final-iteration summary is diffed within the
# 0.5 pt parity budget (BASELINE.md).
#
# The released checkpoint and REAL275 frames ship out-of-band; fetch_assets
# prints what to put where.
set -euo pipefail
cd "$(dirname "$0")/.."

DATA_ROOT=${1:-${CATRE_DATA_ROOT:-datasets}}
OUT=${2:-output/repro_real275_torch}
shift 2 || shift $#
CKPT="$DATA_ROOT/checkpoints/model_final_wo_optim-82cf930e.pth"
CFG=catre_tpu/configs/nocs_real/aug05_kpsMS_r9d_catreDisR_shared_tspcl_convPerRot_scaleexp_120e.py

python -m catre_tpu_torch.tools.fetch_assets --data-root "$DATA_ROOT"

echo "== converting released checkpoint =="
CATRE_DATA_ROOT="$DATA_ROOT" python -m catre_tpu_torch.tools.convert_checkpoint \
  "$CKPT" "$OUT/converted_ckpt" --config-file "$CFG"

echo "== full-split eval (SPD init) =="
CATRE_DATA_ROOT="$DATA_ROOT" ./test_catre_torch.sh "$CFG" 1 "$CKPT" "$@" \
  OUTPUT_DIR="$OUT" \
  DATASETS.INIT_POSE_FILES_TEST="('$DATA_ROOT/NOCS/test_init_poses/init_pose_spd_nocs_real.json',)"

echo "== tables =="
ls "$OUT"/metrics_tab_iter*.txt
cat "$OUT"/metrics_tab_iter4.txt

if [[ -n "${CATRE_REF_SUMMARY_JSON:-}" ]]; then
  echo "== parity diff vs $CATRE_REF_SUMMARY_JSON (0.5 pt budget) =="
  # The sampler's draws and the bf16 eval compute are the noise terms of
  # this budget (docs/DATA.md); MODEL.BF16=False among the args evaluates in f32.
  python -m catre_tpu_torch.tools.repro_diff "$OUT" "$CATRE_REF_SUMMARY_JSON"
fi
