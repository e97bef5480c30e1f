#!/usr/bin/env bash
# The port's counterpart of train_catre.sh:
#   ./train_catre_torch.sh <config> [nchips] [args...]
# nchips (default 0) is --num-chips: processes on this machine, one a card,
# 0 = every card. args are main's options (--device cpu, --resume,
# --num-machines ...) followed by KEY=value overrides.
set -e
CFG=$1
shift || true
NCHIPS=${1:-0}
if [[ "$NCHIPS" =~ ^[0-9]+$ ]]; then shift || true; else NCHIPS=0; fi
exec python -m catre_tpu_torch.main --config-file "$CFG" --num-chips "$NCHIPS" "$@"
