#!/bin/bash
# BASELINE.json config #2: const-vortex (Rankine-like top-hat,
# makefield-const-vortex.cpp) run with the filamentation-time and
# effective-eddy-diffusivity diagnostics — the two README-advertised
# diagnostics the reference never implemented (SURVEY.md §5.10-7).
# The BASELINE grid is NX=512; the default here is scaled down for a
# quick smoke (override: NX=512 STEPS=1200 ./example.sh).
set -e
cd "$(dirname "$0")"
NX=${NX:-256}; STEPS=${STEPS:-300}; REC=${REC:-100}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"

python -m xlab_fftbarotropic.cli.makefield const-vortex -I input \
    --nx $NX --ny $NX
python -m xlab_fftbarotropic.cli.run -I input -O output \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC

# Rozoff et al. 2006 filamentation time + Okubo-Weiss partition on every
# recorded vorticity field (writes filamentation_step_N.bin etc.), and
# Nakamura kappa_eff/kappa profiles with vorticity as the mixed tracer
# (for a run with a REAL passive tracer see examples/03-tracer-mixing).
ls -v output | grep '^vort_step' | awk '{print "output/" $1}' | \
    python -m xlab_fftbarotropic.cli.diagnose --nx $NX --ny $NX \
        -O output -d filamentation -d okubo-weiss -d eddy-diffusivity
