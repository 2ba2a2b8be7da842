"""Passive-tracer family (models/tracer.py, runner -m tracer)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.io.fieldio import read_field, write_field
from xlab_fftbarotropic.models.barotropic import BarotropicModel
from xlab_fftbarotropic.models.tracer import (TracerModel, TracerState,
                                                  tracer_ic)
from xlab_fftbarotropic import runner


def _cfg(**kw):
    return ModelConfig(nx=64, ny=64, **kw)


def test_tracer_with_vorticity_ic_and_kappa_nu_tracks_zeta():
    """q0 = zeta0 and kappa = nu make q satisfy the unforced zeta equation
    — the trajectories must stay together (the passive tendency is the
    same expression modulo the +src term, which is identically zero
    here)."""
    cfg = _cfg(dt=10.0)
    vort0 = makefields.gaussian(cfg, zeta0=2e-3)
    m = TracerModel.build(cfg, kappa=cfg.nu)
    s = m.init_state(vort0, np.asarray(vort0))
    s = m.segment(s, m.zero_source(), 20)
    z = np.asarray(jnp.fft.irfft2(s.zeta_hat, s=cfg.grid_shape))
    q = np.asarray(jnp.fft.irfft2(s.q_hat, s=cfg.grid_shape))
    np.testing.assert_allclose(q, z, atol=1e-6 * np.abs(z).max())


def test_zeta_component_matches_barotropic_model():
    """The joint stepper must not perturb the flow: its zeta trajectory
    equals BarotropicModel's on the same IC."""
    cfg = _cfg(dt=10.0)
    vort0 = makefields.gaussian(cfg, zeta0=2e-3)
    mt = TracerModel.build(cfg, kappa=0.0)
    st = mt.segment(mt.init_state(vort0, tracer_ic(cfg, "zonal")),
                    mt.zero_source(), 10)
    mb = BarotropicModel.build(cfg)
    zb = mb.segment(mb.init_state(vort0), mb.zero_source(), 10)
    np.testing.assert_allclose(np.asarray(st.zeta_hat), np.asarray(zb),
                               atol=1e-6 * float(jnp.abs(zb).max()))


def test_uniform_tracer_is_invariant():
    """Advection and diffusion of a constant are exactly zero (gradients
    and the Laplacian kill the mean mode at the coefficient level)."""
    cfg = _cfg(dt=10.0)
    vort0 = makefields.gaussian(cfg, zeta0=2e-3)
    m = TracerModel.build(cfg, kappa=100.0)
    q0 = np.full(cfg.grid_shape, 3.7, np.float32)
    s = m.segment(m.init_state(vort0, q0), m.zero_source(), 10)
    q = np.asarray(jnp.fft.irfft2(s.q_hat, s=cfg.grid_shape))
    np.testing.assert_allclose(q, 3.7, atol=1e-5)


def test_pure_diffusion_matches_analytic_decay():
    """No flow: q = sin(2 pi x / L) decays exactly as exp(-kappa k^2 t)."""
    cfg = _cfg(dt=10.0)
    kappa = 5e3
    m = TracerModel.build(cfg, kappa=kappa)
    q0 = tracer_ic(cfg, "zonal")
    s = m.segment(m.init_state(np.zeros(cfg.grid_shape), q0),
                  m.zero_source(), 30)
    q = np.asarray(jnp.fft.irfft2(s.q_hat, s=cfg.grid_shape))
    k = 2 * np.pi / cfg.lx
    want = q0 * np.exp(-kappa * k * k * 300.0)
    np.testing.assert_allclose(q, want, atol=2e-6)


def test_mean_conserved_and_kappa_lowers_variance_under_stirring():
    """Stirred by the Kuo2004 vortex pair: the tracer mean is conserved
    and the kappa > 0 run ends with strictly less variance than the
    purely advective run of the same flow. (Comparing against the
    INITIAL variance instead would be flaky: the dealiased advection
    operator is not exactly variance-conserving and pumps ~+3e-4 over
    this horizon — measured while designing this test — which can mask
    a small diffusive decay.)"""
    cfg = _cfg(dt=10.0)
    vort0 = makefields.kuo2004(cfg)
    finals = {}
    for kappa in (0.0, 5e3):
        m = TracerModel.build(cfg, kappa=kappa)
        s0 = m.init_state(vort0, tracer_ic(cfg, "zonal"))
        st0 = m.stats(s0)
        s = m.segment(s0, m.zero_source(), 30)
        st = m.stats(s)
        assert abs(float(st.q_mean) - float(st0.q_mean)) < 1e-6
        finals[kappa] = float(st.q_var)
    assert finals[5e3] < finals[0.0] - 1e-4, finals


def test_nakamura_ratio_grows_under_stirring():
    """Advecting a RADIAL tracer blob through the Kuo2004 vortex pair
    winds its closed contours into spirals: the interior median of the
    Nakamura kappa_eff/kappa profile must grow well past its ~1.05
    starting value (diagnostics/eddy_diffusivity.py on the real tracer
    this family was built to provide). Design notes from probing: the
    L_min = 2 sqrt(pi A) bound assumes CLOSED contours, so an open-
    contour (zonal sin) tracer sits BELOW 1 by construction; and at 64²
    the wound filaments under-resolve (ratio collapses below 1), so this
    runs at 128². Measured medians: 1.05 (t0) -> 1.03/1.10/1.36 at
    30/60/120 steps."""
    from xlab_fftbarotropic.diagnostics.eddy_diffusivity import (
        effective_diffusivity)
    from xlab_fftbarotropic.ops.spectral import SpectralTables

    cfg = ModelConfig(nx=128, ny=128, dt=10.0)
    t = SpectralTables.from_config(cfg)
    vort0 = makefields.kuo2004(cfg)
    m = TracerModel.build(cfg, kappa=0.0)
    s0 = m.init_state(vort0, tracer_ic(cfg, "gaussian"))
    s = m.segment(s0, m.zero_source(), 120)

    def median_ratio(state):
        q = jnp.fft.irfft2(state.q_hat, s=cfg.grid_shape)
        prof = effective_diffusivity(t, q, cfg.dx, cfg.dy, nbins=32)
        r = np.asarray(prof.kappa_ratio_raw)[4:-4]
        return float(np.nanmedian(r))

    r0, r1 = median_ratio(s0), median_ratio(s)
    assert 0.9 < r0 < 1.15, r0          # circular contours: L_e ~ L_min
    assert r1 > r0 * 1.2, (r0, r1)
    assert r1 > 1.25, r1


def test_runner_tracer_records_and_resumes(tmp_path):
    inp = tmp_path / "input"
    inp.mkdir()
    cfg = ModelConfig(nx=32, ny=32, total_steps=4, record_step=2,
                      checkpoint_step=2, input_dir=str(inp),
                      output_dir=str(tmp_path / "out"))
    vort0 = np.asarray(makefields.gaussian(cfg))
    write_field(str(inp / "initial_vorticity.bin"), vort0)

    res = runner.run(cfg, manifest_path=str(tmp_path / "log"),
                     model_kind="tracer", tracer_ic="zonal",
                     tracer_kappa=10.0)
    assert res.steps_run == 4
    # tracer recorded alongside the reference field set
    q0 = read_field(tmp_path / "out" / "q_step_0.bin", (32, 32))
    np.testing.assert_allclose(q0, tracer_ic(cfg, "zonal"), atol=1e-6)
    assert (tmp_path / "out" / "vort_step_2.bin").exists()
    assert (tmp_path / "out" / "q_step_2.bin").exists()
    assert "q_step_2.bin" in (tmp_path / "log").read_text()
    assert "q_var" in res.stats_history[0]

    # resume from the step-2 checkpoint reproduces the straight run
    cfg2 = ModelConfig(nx=32, ny=32, total_steps=4, record_step=2,
                       input_dir=str(inp),
                       output_dir=str(tmp_path / "out2"))
    res2 = runner.run(cfg2, manifest_path=str(tmp_path / "log2"),
                      model_kind="tracer", tracer_ic="zonal",
                      tracer_kappa=10.0,
                      resume_from=str(tmp_path / "out" /
                                      "ckpt_step_2.npz"))
    assert res2.steps_run == 2
    # same final stats as the uninterrupted run
    assert np.isclose(res2.stats_history[-1]["q_var"], res.stats_history[-1]["q_var"],
                      rtol=1e-5)


def test_sharded_tracer_matches_single_device():
    """Slab-decomposed joint stepper on the 8-virtual-device mesh is a
    differential twin of the single-device model (both components)."""
    import jax
    from xlab_fftbarotropic.parallel import (ShardedTracerModel,
                                                 make_mesh)

    cfg = _cfg(dt=10.0)
    vort0 = makefields.gaussian(cfg, zeta0=2e-3)
    q0 = tracer_ic(cfg, "gaussian")
    kappa = 1e3

    single = TracerModel.build(cfg, kappa=kappa)
    ref = single.segment(single.init_state(vort0, q0),
                         single.zero_source(), 5)

    mesh = make_mesh(jax.devices())
    m = ShardedTracerModel.build(cfg, mesh, kappa=kappa)
    s = m.init_state(vort0, q0)
    out = m.unshard_state(m.segment(s, m.zero_source(), 5))
    for got, want in zip(out, ref):
        scale = float(jnp.abs(want).max())
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5 * scale)
    # sharded diags too (drives the distributed inverse on all 5 fields)
    d = m.diags(m.init_state(vort0, q0))
    ds = single.diags(single.init_state(vort0, q0))
    np.testing.assert_allclose(np.asarray(d.q), np.asarray(ds.q),
                               atol=1e-5)


def test_sharded_tracer_xpencil_matches_single_device():
    import jax
    from xlab_fftbarotropic.parallel import (ShardedTracerModel,
                                                 make_mesh)

    cfg = _cfg(dt=10.0)
    vort0 = makefields.gaussian(cfg, zeta0=2e-3)
    q0 = tracer_ic(cfg, "gaussian")
    single = TracerModel.build(cfg, kappa=0.0)
    ref = single.segment(single.init_state(vort0, q0),
                         single.zero_source(), 3)
    mesh = make_mesh(jax.devices())
    m = ShardedTracerModel.build(cfg, mesh, decomp="xpencil")
    out = m.unshard_state(m.segment(m.init_state(vort0, q0),
                                    m.zero_source(), 3))
    for got, want in zip(out, ref):
        scale = max(float(jnp.abs(want).max()), 1e-30)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("decomp", ["slab", "xpencil", "pencil"])
def test_p4_tracer_segment_matches_single(p4_mesh, decomp):
    """Four devices, every decomposition: the sharded tracer segment
    (both prognostic fields) equals the single-device one."""
    from xlab_fftbarotropic.parallel import ShardedTracerModel

    cfg = _cfg(dt=10.0)
    vort0 = makefields.gaussian(cfg, zeta0=2e-3)
    q0 = tracer_ic(cfg, "gaussian")
    single = TracerModel.build(cfg, kappa=50.0)
    ref = single.segment(single.init_state(vort0, q0),
                         single.zero_source(), 4)
    m = ShardedTracerModel.build(cfg, p4_mesh(decomp), decomp=decomp,
                                 kappa=50.0)
    out = m.unshard_state(m.segment(m.init_state(vort0, q0),
                                    m.zero_source(), 4))
    for name, got, want in zip(("zeta", "q"), out, ref):
        want = np.asarray(want)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 1e-5, (name, rel)


def test_runner_sharded_tracer(tmp_path):
    """xfb-run --shard -m tracer end-to-end on the virtual mesh."""
    inp = tmp_path / "input"
    inp.mkdir()
    cfg = ModelConfig(nx=32, ny=32, total_steps=4, record_step=2,
                      input_dir=str(inp),
                      output_dir=str(tmp_path / "out"))
    write_field(str(inp / "initial_vorticity.bin"),
                np.asarray(makefields.gaussian(cfg)))
    res = runner.run(cfg, manifest_path=str(tmp_path / "log"),
                     model_kind="tracer", tracer_ic="gaussian",
                     tracer_kappa=5.0, shard=True)
    assert res.steps_run == 4
    assert (tmp_path / "out" / "q_step_2.bin").exists()
    # matches the unsharded run
    res2cfg = ModelConfig(nx=32, ny=32, total_steps=4, record_step=2,
                          input_dir=str(inp),
                          output_dir=str(tmp_path / "out2"))
    runner.run(res2cfg, manifest_path=str(tmp_path / "log2"),
               model_kind="tracer", tracer_ic="gaussian", tracer_kappa=5.0)
    a = read_field(tmp_path / "out" / "q_step_2.bin", (32, 32))
    b = read_field(tmp_path / "out2" / "q_step_2.bin", (32, 32))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_tracer_ic_presets_shapes_and_errors():
    cfg = _cfg()
    import pytest
    for kind in ("zonal", "meridional", "gaussian"):
        q = tracer_ic(cfg, kind)
        assert q.shape == cfg.grid_shape and q.dtype == np.float32
    v = np.ones(cfg.grid_shape, np.float32)
    np.testing.assert_array_equal(tracer_ic(cfg, "vorticity", v), v)
    with pytest.raises(ValueError):
        tracer_ic(cfg, "vorticity")
    with pytest.raises(ValueError):
        tracer_ic(cfg, "bogus")
