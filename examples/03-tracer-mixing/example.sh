#!/bin/bash
# New-capability pipeline (no reference counterpart): passive-tracer
# mixing analysis. A gaussian tracer blob is stirred by the Kuo2004
# vortex pair; the recorded q_step_*.bin feed the Nakamura
# effective-diffusivity profile (the diagnostic the reference README
# advertises but never implemented) and the isotropic E(k)/Z(k)
# spectra. Flags override the small defaults.
set -e
cd "$(dirname "$0")"
NX=${NX:-128}; STEPS=${STEPS:-300}; REC=${REC:-100}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"

python -m xlab_fftbarotropic.cli.makefield kuo2004 -I input --nx $NX --ny $NX
python -m xlab_fftbarotropic.cli.run -m tracer --tracer-ic gaussian \
    --tracer-kappa 0 -I input -O output \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC

# Nakamura kappa_eff/kappa profiles of the ADVECTED TRACER records
ls -v output | grep '^q_step' | awk '{print "output/" $1}' | \
    python -m xlab_fftbarotropic.cli.diagnose --nx $NX --ny $NX \
        -O output -d eddy-diffusivity

# energy/enstrophy spectra of the flow at the same record steps
ls -v output | grep '^vort_step' | awk '{print "output/" $1}' | \
    python -m xlab_fftbarotropic.cli.diagnose --nx $NX --ny $NX \
        -O output -d spectrum
