#!/usr/bin/env bash
# The port's counterpart of test_catre.sh:
#   ./test_catre_torch.sh <config> <nchips> <checkpoint> [args...]
# The checkpoint is a reference .pth, a directory of the port's checkpoints
# or a JAX orbax directory. args are main's options (--device cpu ...)
# followed by KEY=value overrides; MODEL.WEIGHTS=<checkpoint> goes before the
# overrides, so that one of them may still replace it. (main's overrides are
# its trailing arguments: there is no --opts flag.)
set -e
CFG=$1
NCHIPS=${2:-0}
CKPT=$3
shift 3 || shift $#
OPTS=()
while [[ $# -gt 0 && "$1" == --* ]]; do
  case "$1" in
    --device|--num-chips|--num-machines|--machine-rank|--dist-url) OPTS+=("$1" "$2"); shift 2 ;;
    *) OPTS+=("$1"); shift ;;
  esac
done
exec python -m catre_tpu_torch.main --config-file "$CFG" --num-chips "$NCHIPS" --eval-only \
  ${OPTS[@]+"${OPTS[@]}"} MODEL.WEIGHTS="$CKPT" "$@"
