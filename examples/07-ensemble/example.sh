#!/bin/bash
# Ensemble showcase (new capability, no reference counterpart): an
# M-member perturbed-IC Kuo2004 merger run as ONE vmap-batched program
# (xfb-run --ensemble M). Member 0 is the unperturbed control; each
# member's records land in output/mNN/ with the exact reference layout,
# so the reference postproc chain (invert_pres -> find_min,
# test/02-test_invert_pressure/invert.sh) runs unchanged per member.
# The final block reduces the per-member minima tracks to an ensemble
# spread of the merged-vortex position/depth.
set -e
cd "$(dirname "$0")"
NX=${NX:-128}; STEPS=${STEPS:-300}; REC=${REC:-100}; M=${M:-4}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"

python -m xlab_fftbarotropic.cli.makefield kuo2004 -I input --nx $NX --ny $NX
python -m xlab_fftbarotropic.cli.run -I input -O output \
    --nx $NX --ny $NX --total-steps $STEPS --record-step $REC \
    --ensemble $M --ensemble-amp 0.02 --ensemble-seed 7

# reference postproc per member: psi records -> pressure -> minima track
for d in output/m*/; do
    m=$(basename "$d")
    grep "$m/psi_step" log | sed 's/psi/pres/' \
        | paste -d'@' <(grep "$m/psi_step" log) - | sed 's/@/=>/' \
        | python -m xlab_fftbarotropic.cli.invert_pres --nx $NX --ny $NX
    ls -v "$d" | grep pres_step | awk -v d="$d" '{print d $1}' \
        | python -m xlab_fftbarotropic.cli.find_min --nx $NX --ny $NX -n 1 \
        > "$d/pres_timeseries.txt"
done

python ./spread.py output > output/ensemble_spread.txt
cat output/ensemble_spread.txt
