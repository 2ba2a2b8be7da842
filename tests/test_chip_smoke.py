"""chip_smoke.py's own logic on the CPU: what it refuses, what it prints,
and each phase's comparison at a tiny size with the CPU as the device.
On the card the same functions run at real sizes (tests/test_gpu.py and
`python chip_smoke.py`)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke as cs

REPO = Path(__file__).resolve().parents[1]
CPU = jax.devices("cpu")[0]


@pytest.mark.parametrize("line, name, limit", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3",
     "700.00 W"),
    ("NVIDIA H100, PCIe, 350.00 W", "NVIDIA H100, PCIe", "350.00 W"),
])
def test_parse_smi_line(line, name, limit):
    assert cs.parse_smi(line) == {"name": name, "power_limit": limit}


@pytest.mark.parametrize("line", ["", "no comma here", "NVIDIA H100, "])
def test_parse_smi_rejects_malformed(line):
    with pytest.raises(cs.SmokeFailure):
        cs.parse_smi(line)


def test_require_gpu_refuses_cpu():
    with pytest.raises(cs.SmokeFailure, match="not 'gpu'"):
        cs.require_gpu(jax.devices())
    with pytest.raises(cs.SmokeFailure):
        cs.require_gpu([])


def test_result_line_is_the_contract():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    cs.require_gpu([Dev()])            # a GPU passes
    line = cs.result_line([Dev()] * 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_tolerance_per_field():
    """1e-5 everywhere but SW eta (integrates -H*div), which gets 5e-5;
    a NaN never passes."""
    assert cs.tolerance("zeta") == cs.TOL == 1e-5
    assert cs.tolerance("eta") == cs.ETA_TOL == 5e-5
    assert cs._failed({"zeta": 2e-5, "eta": 2e-5, "q": float("nan"),
                       "div": 1e-6}) == ["zeta", "q"]


@pytest.mark.parametrize("n", [512, 4096])
def test_sw_dt_choice(n):
    """SW RK4 runs at max_stable_dt, SW-ETDRK4 at twice it."""
    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.models.shallow_water import max_stable_dt
    bound = max_stable_dt(ModelConfig(nx=n, ny=n))
    assert cs._family_setup("sw", n)[0].dt == bound
    etd = cs._family_setup("sw-etdrk4", n)[0]
    assert etd.time_scheme == "etdrk4" and etd.dt == 2.0 * bound


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_without_gpu(tmp_path, alone):
    """No card (and, `alone`, none of the repo beside the script): exit
    non-zero before any model phase, and print no result line."""
    if shutil.which("nvidia-smi"):
        pytest.skip("a GPU machine runs the real smoke instead")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "[phase 2]" not in r.stdout


def test_compare_oracle_tiny_on_cpu():
    assert cs.compare_oracle(CPU, n=32, steps=3) < 1e-6


@pytest.mark.parametrize("family", cs.FAMILIES)
def test_compare_family_tiny_on_cpu(family):
    """The card-vs-CPU comparison with the CPU on both sides: identical
    programs, so every field agrees exactly."""
    errs = cs.compare_family(family, CPU, n=32, steps=3)
    assert set(errs) == set(cs._family_setup(family, 32)[3])
    assert all(v == 0.0 for v in errs.values()), errs


def test_measure_family_reports_step_numbers():
    r = cs.measure_family("barotropic", 32, steps=2)
    assert r["ms_per_step"] > 0 and r["step_compile_s"] > 0
    assert r["step_memory_analysis"]["output_size_in_bytes"] > 0


def test_reference_pipeline_tiny(tmp_path):
    """The README pipeline through the CLI entry points at 64^2: a
    FIFO-fed run of 200 steps, two records, pressure inversion and the
    minima file; the producer process never touches a GPU."""
    r = cs.reference_pipeline(64, 200, work=tmp_path / "w")
    assert r["records"] == 2
    assert r["producer_card_samples"] > 0
    text = (tmp_path / "w" / "output" / "pres_timeseries.txt").read_text()
    assert len(text.split("\n")) >= 60
