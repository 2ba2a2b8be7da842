"""Isotropic energy/enstrophy spectra (diagnostics/spectra.py)."""

import io
import sys

import numpy as np
import jax.numpy as jnp

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.diagnostics.spectra import (
    energy_enstrophy_spectrum, shell_tables)
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.models.barotropic import BarotropicModel, \
    step_stats
from xlab_fftbarotropic.ops import fft
from xlab_fftbarotropic.ops.spectral import SpectralTables


def _cfg(**kw):
    return ModelConfig(nx=64, ny=64, **kw)


def test_single_mode_lands_in_its_shell():
    cfg = _cfg()
    t = SpectralTables.from_config(cfg)
    x, _ = cfg.coords()
    for m in (3, 7):
        z = (np.cos(2 * np.pi * m * np.asarray(x) / cfg.lx)[:, None]
             * np.ones((1, cfg.ny), np.float32))
        sp = energy_enstrophy_spectrum(t, fft.forward(jnp.asarray(z)), cfg)
        zk = np.asarray(sp.enstrophy)
        assert np.argmax(zk) == m
        assert zk[m] > 0.999 * zk.sum()
        # Z(m) = 0.5 * mean(zeta^2) = 0.25 for a unit cosine
        np.testing.assert_allclose(zk[m], 0.25, rtol=1e-5)
        # E(m) = Z(m) / k^2
        k = 2 * np.pi * m / cfg.lx
        np.testing.assert_allclose(np.asarray(sp.energy)[m], 0.25 / k ** 2,
                                   rtol=1e-4)


def test_parseval_against_step_stats():
    """sum E(k) and sum Z(k) must reproduce the StepStats energy and
    enstrophy scalars (independently computed through physical-space
    means). For the smooth gaussian field this is exact to float32;
    for a Nyquist-rich field the ENERGY defect is the documented
    positive-Nyquist-convention sliver (diagnostics/spectra.py module
    note) — pinned here at its measured 1.7e-4 scale, vanishing when
    the Nyquist row/column are zeroed."""
    cfg = _cfg()
    t = SpectralTables.from_config(cfg)
    m = BarotropicModel.build(cfg)

    z = m.segment(m.init_state(makefields.gaussian(cfg)),
                  m.zero_source(), 10)
    sp, st = energy_enstrophy_spectrum(t, z, cfg), step_stats(t, z, cfg)
    np.testing.assert_allclose(float(np.asarray(sp.enstrophy).sum()),
                               float(st.enstrophy), rtol=1e-5)
    np.testing.assert_allclose(float(np.asarray(sp.energy).sum()),
                               float(st.energy), rtol=1e-5)

    z = m.segment(m.init_state(makefields.kuo2004(cfg)),
                  m.zero_source(), 10)
    sp, st = energy_enstrophy_spectrum(t, z, cfg), step_stats(t, z, cfg)
    np.testing.assert_allclose(float(np.asarray(sp.enstrophy).sum()),
                               float(st.enstrophy), rtol=1e-4)
    e_defect = (float(np.asarray(sp.energy).sum()) - float(st.energy)) \
        / float(st.energy)
    assert 0 <= e_defect < 1e-3, e_defect   # spectral sum >= physical
    zq = np.asarray(z).copy()
    zq[cfg.nx // 2, :] = 0
    zq[:, -1] = 0
    zq = jnp.asarray(zq)
    sp2, st2 = energy_enstrophy_spectrum(t, zq, cfg), step_stats(t, zq, cfg)
    np.testing.assert_allclose(float(np.asarray(sp2.energy).sum()),
                               float(st2.energy), rtol=1e-5)


def test_shell_tables_cover_every_mode():
    cfg = _cfg()
    shell, w, n = shell_tables(cfg)
    assert shell.min() == 0 and shell.max() == n - 1
    # multiplicities reconstruct the full-spectrum mode count
    assert int(w.sum()) == cfg.nx * cfg.ny


def test_draw_spectra_renders_png(tmp_path):
    from xlab_fftbarotropic.viz.plots import draw_spectra

    cfg = _cfg()
    t = SpectralTables.from_config(cfg)
    sp = energy_enstrophy_spectrum(
        t, fft.forward(jnp.asarray(makefields.gaussian(cfg))), cfg)
    np.savetxt(tmp_path / "spectrum_step_0.txt",
               np.column_stack([np.asarray(sp.k), np.asarray(sp.energy),
                                np.asarray(sp.enstrophy)]))
    made = draw_spectra(tmp_path, tmp_path / "figs")
    assert len(made) == 1
    assert made[0].exists() and made[0].stat().st_size > 5000


def test_diagnose_cli_spectrum(tmp_path, monkeypatch):
    from xlab_fftbarotropic.cli import diagnose
    from xlab_fftbarotropic.io.fieldio import write_field

    cfg = _cfg()
    vort = np.asarray(makefields.gaussian(cfg))
    src = tmp_path / "vort_step_0.bin"
    write_field(str(src), vort)
    monkeypatch.setattr(sys, "stdin", io.StringIO(str(src) + "\n"))
    diagnose.main(["--nx", "64", "--ny", "64", "-O", str(tmp_path),
                   "-d", "spectrum"])
    out = np.loadtxt(tmp_path / "spectrum_step_0.txt")
    assert out.shape[1] == 3
    t = SpectralTables.from_config(cfg)
    sp = energy_enstrophy_spectrum(t, fft.forward(jnp.asarray(vort)), cfg)
    np.testing.assert_allclose(out[:, 2], np.asarray(sp.enstrophy),
                               rtol=1e-5, atol=1e-30)
