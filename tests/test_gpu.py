"""Checks that need the card: the phase-4 comparisons of chip_smoke.py at
their real sizes, on the GPU. They skip without a GPU (the gpu_device
fixture decides at run time); `python chip_smoke.py` runs the same
checks. Run them on the card with `python -m pytest -m gpu tests/`."""

import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_barotropic_matches_oracle_on_gpu(gpu_device):
    assert cs.compare_oracle(gpu_device) <= cs.TOL


@pytest.mark.parametrize("family", cs.FAMILIES)
def test_family_matches_cpu_on_gpu(gpu_device, family):
    errs = cs.compare_family(family, gpu_device)
    assert not cs._failed(errs), errs
