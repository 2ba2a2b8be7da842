#!/bin/bash
# BASELINE.json config #4: the Kuo2004 binary-vortex merger
# (makefield-Kuo2004.cpp: 1.5e-2/10km + 3e-3/30km cake vortices) on the
# finite-difference cross-check core — the capability of the reference's
# unbuildable main-jacobian.cpp (missing external xdmlab header,
# SURVEY.md C16): Arakawa Jacobian advection + FFT-diagonalized 5-point
# Poisson solve, RK4. The same IC is also run on the spectral core and
# the final recorded vorticity fields are compared — the FD-vs-spectral
# cross-check main-jacobian was presumably built for.
# The BASELINE config is NX=2048, STEPS=10000; defaults here are scaled
# down for a quick smoke (override: NX=2048 STEPS=10000 ./example.sh).
set -e
cd "$(dirname "$0")"
NX=${NX:-256}; STEPS=${STEPS:-300}; REC=${REC:-100}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"

python -m xlab_fftbarotropic.cli.makefield kuo2004 -I input --nx $NX --ny $NX
python -m xlab_fftbarotropic.cli.run -m fd -I input -O output-fd \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    --manifest log-fd
python -m xlab_fftbarotropic.cli.run -I input -O output-spectral \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    --manifest log-spectral

LAST=$(( (STEPS - 1) / REC * REC ))
python - "$NX" "$LAST" <<'EOF'
import sys
import numpy as np
nx, last = int(sys.argv[1]), int(sys.argv[2])
fd = np.fromfile(f"output-fd/vort_step_{last}.bin", "<f4")
sp = np.fromfile(f"output-spectral/vort_step_{last}.bin", "<f4")
rel = np.linalg.norm(fd - sp) / np.linalg.norm(sp)
print(f"# FD vs spectral vorticity at step {last}: rel-L2 = {rel:.3e} "
      f"(O(dx^2) discretization error; shrinks under grid refinement — "
      f"see tests/test_fd_core.py convergence suite)")
EOF
