#!/bin/bash
# BASELINE.json config #3: elliptic-vortex IC (makefield-elliptic-vortex.cpp
# parameters: eps=0.7, smooth cake taper) with vorticity-source forcing
# through the reference's FIFO flag-byte protocol, and Hsu's
# deformation-factor diagnostic on every recorded state (SURVEY.md
# §5.10-7 — advertised by the reference README, implemented here).
# The BASELINE grid is NX=1024; the default is scaled down for a quick
# smoke (override: NX=1024 STEPS=1200 ./example.sh).
set -e
cd "$(dirname "$0")"
NX=${NX:-256}; STEPS=${STEPS:-300}; REC=${REC:-100}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"

python -m xlab_fftbarotropic.cli.makefield elliptic-vortex -I input \
    --nx $NX --ny $NX

# producer/consumer pair over a named FIFO, exactly the reference's
# test/02-test_invert_pressure/example.sh:10-13 topology
rm -f vort_src_fifo; mkfifo vort_src_fifo
python -m xlab_fftbarotropic.cli.vort_src_input \
    --nx $NX --ny $NX --total-steps $STEPS > vort_src_fifo &
PROD=$!
python -m xlab_fftbarotropic.cli.run -I input -O output \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC -f vort_src_fifo
wait $PROD

# deformation factor D = sqrt(S1^2+S2^2)/|zeta| per recorded state
ls -v output | grep '^vort_step' | awk '{print "output/" $1}' | \
    python -m xlab_fftbarotropic.cli.diagnose --nx $NX --ny $NX \
        -O output -d deformation
