#!/bin/bash
# Reference test/02-test_invert_pressure/invert.sh equivalent: the perl/awk
# pipeline mapping psi records -> pressure fields -> minima time series.
set -e
cd "$(dirname "$0")"
NX=${NX:-256}
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(cd ../.. && pwd)"
grep psi_step log | sed 's/psi/pres/' | paste -d'@' <(grep psi_step log) - | sed 's/@/=>/' \
    | python -m xlab_fftbarotropic.cli.invert_pres --nx $NX --ny $NX
ls -v output | grep pres_step | awk '{print "output/" $1}' \
    | python -m xlab_fftbarotropic.cli.find_min --nx $NX --ny $NX > output/pres_timeseries.txt
echo "pressure minima time series -> output/pres_timeseries.txt"
