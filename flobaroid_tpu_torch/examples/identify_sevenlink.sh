#!/bin/bash
# Full pipeline example through the port's commands: optimize an
# excitation trajectory, simulate measurements, identify parameters (with
# SDP consistency), export URDF. The work runs on the card; set DEVICE=cpu
# in the environment for a host without one. The model is copied into the
# output directory first, so the structural cache is written there and
# not beside the repository's model; the identifier runs there too (it
# writes its HTML report to the working directory).
set -e
cd "$(dirname "$0")/../.."
REPO=$(pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
CFG=$REPO/examples/configs/sevenlink_arm.yaml
OUT=${TMPDIR:-/tmp}/flobaroid_torch_sevenlink
DEVICE=${DEVICE:-cuda}
mkdir -p "$OUT"
cp examples/models/sevenlink_arm.urdf "$OUT/"
MODEL=$OUT/sevenlink_arm.urdf
# --plot needs matplotlib
PLOT=$(python -c 'import matplotlib' 2>/dev/null && echo --plot || true)

python -m flobaroid_tpu_torch.cli.trajectory --config "$CFG" --model "$MODEL" \
    --filename "$OUT/trajectory.npz" --device "$DEVICE"
python -m flobaroid_tpu_torch.cli.simulator --config "$CFG" --model "$MODEL" \
    --trajectory "$OUT/trajectory.npz" --filename "$OUT/measurements.npz" --device "$DEVICE"
cd "$OUT"
python -m flobaroid_tpu_torch.cli.identifier --config "$CFG" --model "$MODEL" \
    --measurements "$OUT/measurements.npz" --model_real "$MODEL" \
    --model_output "$OUT/identified.urdf" --trajectory "$OUT/trajectory.npz" \
    --device "$DEVICE" $PLOT
echo "artifacts in $OUT"
