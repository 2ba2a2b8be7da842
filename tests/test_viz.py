"""Visualization tests: PNG rendering from a real (tiny) run's outputs."""

import numpy as np
import pytest

pytest.importorskip("matplotlib")

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic import runner
from xlab_fftbarotropic.viz.plots import (
    cmap_vorticity, draw_run, load_step)


@pytest.fixture(scope="module")
def run_outputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("vizrun")
    cfg = ModelConfig(nx=32, ny=32, total_steps=20, record_step=10,
                      output_dir=str(d / "output"))
    runner.run(cfg, vort0=makefields.gaussian(cfg),
               manifest_path=str(d / "log"), collect_stats=False)
    return cfg, d


def test_cmap_builds():
    c = cmap_vorticity()
    assert c(0.0) is not None and c(1.0) is not None


def test_load_step_transposes(run_outputs):
    cfg, d = run_outputs
    f = load_step(cfg, cfg.output_dir, 0)
    assert f["vort"].shape == (cfg.ny, cfg.nx)
    # the raw file is x-major; transpose means [j, i] indexing
    from xlab_fftbarotropic.io.fieldio import read_field
    raw = read_field(f"{cfg.output_dir}/vort_step_0.bin", cfg.grid_shape)
    np.testing.assert_array_equal(f["vort"], raw.T)


@pytest.mark.parametrize("wind", ["streamline", "barb", "none"])
def test_draw_run_produces_pngs(run_outputs, tmp_path, wind):
    cfg, d = run_outputs
    made = draw_run(cfg, cfg.output_dir, tmp_path / wind, wind=wind, dpi=40)
    assert len(made) == 2  # steps 0 and 10
    for p in made:
        head = open(p, "rb").read(8)
        assert head[:4] == b"\x89PNG"


def test_draw_cli(run_outputs, tmp_path):
    from xlab_fftbarotropic.cli import draw
    cfg, d = run_outputs
    draw.main(["-O", cfg.output_dir, "--fig-dir", str(tmp_path / "figs"),
               "--nx", "32", "--ny", "32", "--total-steps", "20",
               "--record-step", "10", "--wind", "none", "--dpi", "40"])
    assert (tmp_path / "figs" / "step_0.png").exists()
