#!/bin/bash
# Reference test/02-test_invert_pressure/example.sh with this framework:
# Kuo2004 merger IC, FIFO-forced run, pressure inversion, minima tracking.
set -e
cd "$(dirname "$0")"
NX=${NX:-256}; STEPS=${STEPS:-300}; REC=${REC:-100}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"
python -m xlab_fftbarotropic.cli.makefield kuo2004 -I input --nx $NX --ny $NX
rm -f vort_src_fifo; mkfifo vort_src_fifo
python -m xlab_fftbarotropic.cli.vort_src_input \
    --nx $NX --ny $NX --total-steps $STEPS > vort_src_fifo &
PROD=$!
python -m xlab_fftbarotropic.cli.run -I input -O output \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC -f vort_src_fifo
wait $PROD
./invert.sh
