#!/bin/bash
# Reference test/01-runtest/draw.sh equivalent.
set -e
cd "$(dirname "$0")"
NX=${NX:-256}; STEPS=${STEPS:-300}; REC=${REC:-100}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"
python -m xlab_fftbarotropic.cli.draw -O output --fig-dir output_fig \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC
