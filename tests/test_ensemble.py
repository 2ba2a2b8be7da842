"""Ensemble family (models/ensemble.py, runner --ensemble).

The member physics must be EXACTLY the single-run models (vmap changes
batching, not math — FFT batching differences stay at float32 round-off),
member 0 is the unperturbed control, and the runner writes each member's
records in the reference file layout under output/mNN/.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.io.fieldio import read_field, write_field
from xlab_fftbarotropic.models.barotropic import BarotropicModel
from xlab_fftbarotropic.models.ensemble import (EnsembleModel,
                                                    perturb_vorticity)
from xlab_fftbarotropic import runner


def _cfg(**kw):
    return ModelConfig(nx=64, ny=64, **kw)


def test_perturbation_batch_properties():
    cfg = _cfg()
    vort0 = makefields.gaussian(cfg, zeta0=2e-3)
    batch = np.asarray(perturb_vorticity(cfg, vort0, 4, amplitude=0.1,
                                         seed=7))
    assert batch.shape == (4, 64, 64)
    # member 0 is the control
    np.testing.assert_array_equal(batch[0], np.asarray(vort0))
    # perturbations are normalized: rms(delta) == amplitude * rms(vort0)
    rms0 = np.sqrt(np.mean(np.asarray(vort0) ** 2))
    for k in range(1, 4):
        delta = batch[k] - batch[0]
        np.testing.assert_allclose(np.sqrt(np.mean(delta ** 2)),
                                   0.1 * rms0, rtol=1e-4)
        # band-limited noise has zero mean (mean mode masked off)
        assert abs(delta.mean()) < 1e-3 * 0.1 * rms0
    # deterministic in the seed
    again = np.asarray(perturb_vorticity(cfg, vort0, 4, amplitude=0.1,
                                         seed=7))
    np.testing.assert_array_equal(batch, again)
    other = np.asarray(perturb_vorticity(cfg, vort0, 4, amplitude=0.1,
                                         seed=8))
    assert np.abs(other[1] - batch[1]).max() > 0


def test_zero_amp_members_match_solo_barotropic():
    cfg = _cfg(dt=10.0)
    vort0 = makefields.gaussian(cfg, zeta0=2e-3)
    solo = BarotropicModel.build(cfg)
    z_solo = np.asarray(solo.segment(solo.init_state(vort0),
                                     solo.zero_source(), 20))
    ens = EnsembleModel.build(cfg, 3)
    state = ens.init_from_physical(vort0, amplitude=0.0)
    out = np.asarray(ens.segment(state, solo.zero_source(), 20))
    tol = 1e-6 * np.abs(z_solo).max()
    for k in range(3):
        np.testing.assert_allclose(out[k], z_solo, atol=tol)


def test_control_member_matches_solo_under_perturbation():
    """amplitude > 0 perturbs members 1+ only; member 0 still tracks the
    solo trajectory and the perturbed members leave it."""
    cfg = _cfg(dt=10.0)
    vort0 = makefields.kuo2004(cfg)
    solo = BarotropicModel.build(cfg)
    z_solo = np.asarray(solo.segment(solo.init_state(vort0),
                                     solo.zero_source(), 10))
    ens = EnsembleModel.build(cfg, 3)
    state = ens.init_from_physical(vort0, amplitude=0.02, seed=1)
    final = ens.segment(state, solo.zero_source(), 10)
    out = np.asarray(final)
    tol = 1e-6 * np.abs(z_solo).max()
    np.testing.assert_allclose(out[0], z_solo, atol=tol)
    assert np.abs(out[1] - z_solo).max() > 100 * tol
    # spread over the perturbed ensemble is a positive scalar
    assert float(ens.spread(final)) > 0.0


def test_chunked_width_matches_full_vmap():
    """lax.map-over-vmap chunking (the measured large-grid default) is a
    pure execution-schedule change — identical trajectories."""
    cfg = _cfg(dt=10.0)
    vort0 = makefields.kuo2004(cfg)
    full = EnsembleModel.build(cfg, 4, vmap_width=4)
    state = full.init_from_physical(vort0, amplitude=0.05, seed=2)
    out_full = np.asarray(full.segment(state, jnp.zeros(cfg.grid_shape,
                                                        jnp.float32), 10))
    for width in (1, 2):
        chunked = EnsembleModel.build(cfg, 4, vmap_width=width)
        assert chunked.vmap_width == width
        out = np.asarray(chunked.segment(
            state, jnp.zeros(cfg.grid_shape, jnp.float32), 10))
        np.testing.assert_allclose(out, out_full, rtol=0,
                                   atol=1e-6 * np.abs(out_full).max())
    import pytest as _pytest
    with _pytest.raises(ValueError, match="divide"):
        EnsembleModel.build(cfg, 4, vmap_width=3)


def test_auto_vmap_width_crossover():
    from xlab_fftbarotropic.models.ensemble import auto_vmap_width
    assert auto_vmap_width(ModelConfig(nx=256, ny=256), 64) == 64
    assert auto_vmap_width(ModelConfig(nx=512, ny=512), 32) == 8
    assert auto_vmap_width(ModelConfig(nx=1024, ny=1024), 8) == 1
    # snapped down to a divisor
    assert auto_vmap_width(ModelConfig(nx=512, ny=512), 12) == 6


def test_member_backend_passes_through():
    """Members run the configured transform backend at every chunk width:
    'auto' stays 'auto' (jnp.fft) and an explicit 'mxu' is honoured."""
    for backend in ("auto", "mxu"):
        cfg = ModelConfig(nx=32, ny=32, fft_backend=backend)
        for width in (1, 2):
            ens = EnsembleModel.build(cfg, 2, vmap_width=width)
            assert ens.cfg.fft_backend == backend
            assert ens.inner.cfg.fft_backend == backend


def test_zero_amp_members_match_solo_sw():
    from xlab_fftbarotropic.models.shallow_water import ShallowWaterModel
    cfg = _cfg(dt=3.0)
    vort0 = makefields.gaussian(cfg, zeta0=2e-3)
    solo = ShallowWaterModel.build(cfg)
    s_solo = solo.segment(solo.geostrophic_init(vort0),
                          solo.zero_source(), 10)
    ens = EnsembleModel.build(cfg, 2, model_kind="sw")
    out = ens.segment(ens.init_from_physical(vort0, amplitude=0.0),
                      solo.zero_source(), 10)
    for leaf_s, leaf_e in zip(s_solo, out):
        a = np.asarray(leaf_s)
        tol = 1e-6 * max(np.abs(a).max(), 1e-20)
        for k in range(2):
            np.testing.assert_allclose(np.asarray(leaf_e)[k], a, atol=tol)


def test_runner_ensemble_end_to_end(tmp_path):
    cfg = _cfg(dt=10.0, record_step=5, total_steps=10,
               input_dir=str(tmp_path / "input"),
               output_dir=str(tmp_path / "output"))
    Path(cfg.input_dir).mkdir(parents=True)
    vort0 = np.asarray(makefields.gaussian(cfg, zeta0=2e-3))
    write_field(Path(cfg.input_dir) / cfg.init_file, vort0)

    res = runner.run(cfg, manifest_path=str(tmp_path / "log"),
                     ensemble=2, ensemble_amp=0.05, ensemble_seed=3)
    assert res.steps_run == 10
    out = Path(cfg.output_dir)
    for k in ("m00", "m01"):
        for name in ("vort", "psi", "u", "v"):
            for step in (0, 5):
                f = out / k / f"{name}_step_{step}.bin"
                assert f.exists(), f
    # member-0 records equal a solo run's records (control member parity)
    solo_cfg = ModelConfig(nx=64, ny=64, dt=10.0, record_step=5,
                           total_steps=10, input_dir=cfg.input_dir,
                           output_dir=str(tmp_path / "solo_out"),
                           fft_backend="xla")
    runner.run(solo_cfg, manifest_path=str(tmp_path / "solo_log"))
    for step in (0, 5):
        a = read_field(out / "m00" / f"vort_step_{step}.bin", (64, 64))
        b = read_field(Path(solo_cfg.output_dir) / f"vort_step_{step}.bin",
                       (64, 64))
        np.testing.assert_allclose(a, b, atol=1e-6 * np.abs(b).max())
    # manifest mentions both member trees
    lines = (tmp_path / "log").read_text().splitlines()
    assert any("m00/" in ln for ln in lines)
    assert any("m01/" in ln for ln in lines)
    # ensemble stats aggregate member scalars
    st = res.stats_history[0]
    assert "energy_mean" in st and "energy_std" in st and "spread" in st


def test_runner_ensemble_checkpoint_resume(tmp_path):
    cfg = _cfg(dt=10.0, record_step=20, total_steps=10, checkpoint_step=5,
               input_dir=str(tmp_path / "input"),
               output_dir=str(tmp_path / "output"))
    Path(cfg.input_dir).mkdir(parents=True)
    vort0 = np.asarray(makefields.gaussian(cfg, zeta0=2e-3))
    write_field(Path(cfg.input_dir) / cfg.init_file, vort0)
    full = runner.run(cfg, manifest_path=str(tmp_path / "log"),
                      ensemble=2, ensemble_amp=0.05)
    ckpt = Path(cfg.output_dir) / "ckpt_step_5.npz"
    assert ckpt.exists()
    resumed = runner.run(cfg, manifest_path=str(tmp_path / "log2"),
                         resume_from=ckpt, ensemble=2, ensemble_amp=0.05)
    np.testing.assert_allclose(np.asarray(resumed.zeta_hat),
                               np.asarray(full.zeta_hat), rtol=0,
                               atol=1e-12)


def test_ensemble_script_forcing_shared_across_members(tmp_path):
    """SCRIPT forcing drives the whole ensemble with ONE shared source
    stream (SURVEY.md §3.2 protocol): forced zero-amp members must match
    a forced solo run."""
    cfg = _cfg(dt=3.0, record_step=5, total_steps=10,
               input_dir=str(tmp_path / "input"),
               output_dir=str(tmp_path / "output"))
    Path(cfg.input_dir).mkdir(parents=True)
    vort0 = np.asarray(makefields.gaussian(cfg, zeta0=2e-3))
    write_field(Path(cfg.input_dir) / cfg.init_file, vort0)
    src_field = (0.1 * vort0).astype(np.float32)
    write_field(tmp_path / "s.bin", src_field)
    script = tmp_path / "recipe.txt"
    script.write_text(f"9.0 {tmp_path}/s.bin\n")   # fires at step 3

    res = runner.run(cfg, recipe="script", src_path=str(script),
                     manifest_path=str(tmp_path / "log"),
                     ensemble=2, ensemble_amp=0.0)
    solo_cfg = ModelConfig(nx=64, ny=64, dt=3.0, record_step=5,
                           total_steps=10, input_dir=cfg.input_dir,
                           output_dir=str(tmp_path / "solo_out"),
                           fft_backend="xla")
    runner.run(solo_cfg, recipe="script", src_path=str(script),
               manifest_path=str(tmp_path / "solo_log"))
    a = read_field(Path(cfg.output_dir) / "m01" / "vort_step_5.bin",
                   (64, 64))
    b = read_field(Path(solo_cfg.output_dir) / "vort_step_5.bin", (64, 64))
    np.testing.assert_allclose(a, b, atol=1e-6 * np.abs(b).max())
    assert res.steps_run == 10


def test_ensemble_rejects_shard_and_fd():
    cfg = _cfg()
    with pytest.raises(ValueError, match="mutually exclusive"):
        runner.make_adapter(cfg, "barotropic", shard=True, ensemble=2)
    with pytest.raises(ValueError, match="not supported"):
        runner.make_adapter(cfg, "fd", ensemble=2)
