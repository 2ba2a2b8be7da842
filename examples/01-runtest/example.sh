#!/bin/bash
# Reference test/01-runtest/example.sh with this framework's CLIs:
# makefield -> model run -> figures. Flags override the 768^2 default.
set -e
cd "$(dirname "$0")"
NX=${NX:-256}; STEPS=${STEPS:-300}; REC=${REC:-100}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"
python -m xlab_fftbarotropic.cli.makefield gaussian -I input --nx $NX --ny $NX
python -m xlab_fftbarotropic.cli.run -I input -O output \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC
