"""Temporal (RK4) convergence suite — the test strategy the reference only
planned (/root/reference/TODO.md:13 "Write test suite (by convergence)",
SURVEY.md §4).

Float32 + chaotic advection makes a naive dt-refinement sweep useless (the
chaos-amplified round-off floor sits at ~2e-6 after a few hundred seconds,
measured while designing this suite), so each case is built to expose the
pure time-integration error:

* Barotropic: a single Fourier mode is an EXACT nonlinear solution
  (psi ∝ zeta ⇒ the Jacobian vanishes identically — and it vanishes
  exactly in the discrete model too: ky=0 kills u_hat and zeta_y at the
  coefficient level), so with a large viscosity the trajectory is the
  closed form zeta_hat(T) = zeta_hat(0)·exp(-nu k² T) and the measured
  error is exactly the RK4-vs-exp defect. The mode sits near the dealias
  cutoff so nu can be large for THIS mode (nu k² dt = 0.4) while the
  highest retained mode stays inside RK4's real-axis stability interval
  (|z| < 2.79). Comparison is per-mode: the other modes carry
  non-decaying f32 init leakage that would floor a whole-field norm at
  ~3e-4 (measured).

* Shallow water: standing gravity wave (f=0, nu=0) self-convergence of
  eta_hat against a dt/16 reference — comparing eta_hat, not h = H + eta,
  because f32 quantization of h at H=1000 m (ulp 6e-5 m) swallows the
  ~1e-7-relative temporal differences outright (measured: bit-identical
  h across dt).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.models.barotropic import BarotropicModel
from xlab_fftbarotropic.models.shallow_water import ShallowWaterModel


def test_barotropic_rk4_is_fourth_order_in_dt():
    """Error of the (16,0) mode vs the exact viscous decay falls ~16x per
    dt halving (measured 18.9x / 17.8x — the >16 comes from the exp(z)
    Taylor tail; asserted > 12)."""
    L = 600e3
    nmode, T = 16, 480.0
    k = 2 * np.pi * nmode / L
    nu = 0.4 / (k * k * 30.0)       # z = nu k^2 dt = 0.4 at dt=30

    errs = []
    for dt in (30.0, 15.0, 7.5):
        cfg = ModelConfig(nx=64, ny=64, dt=dt, nu=nu)
        m = BarotropicModel.build(cfg)
        x, _ = cfg.coords()
        z0 = (1e-3 * np.cos(k * x))[:, None] * np.ones((1, cfg.ny),
                                                       np.float32)
        zh0 = m.init_state(z0)
        out = m.segment(zh0, jnp.zeros(cfg.grid_shape, jnp.float32),
                        int(round(T / dt)))
        a0 = complex(np.asarray(zh0)[nmode, 0])
        aT = complex(np.asarray(out)[nmode, 0])
        want = a0 * np.exp(-nu * k * k * T)
        errs.append(abs(aT - want) / abs(want))

    assert errs[0] / errs[1] > 12.0, errs
    assert errs[1] / errs[2] > 12.0, errs
    # absolute sanity: dt=7.5 lands within float32 reach of the closed form
    assert errs[2] < 5e-5, errs


def test_shallow_water_rk4_is_fourth_order_in_dt():
    """Standing-gravity-wave eta_hat self-convergence: measured ratios
    15.6x / 9.4x (the second refinement grazes the f32 round-off floor at
    ~3e-7); asserted > 10 and > 5."""
    nmode, T = 8, 480.0

    outs = {}
    for dt in (24.0, 12.0, 6.0, 1.5):
        cfg = ModelConfig(nx=64, ny=64, f=0.0, nu=0.0, dt=dt)
        m = ShallowWaterModel.build(cfg)
        k = 2 * np.pi * nmode / cfg.lx
        x, _ = cfg.coords()
        amp = 1e-4 * cfg.mean_depth
        hp0 = (amp * np.cos(k * x))[:, None] * np.ones((1, cfg.ny),
                                                       np.float32)
        s = m.init_state(np.zeros(cfg.grid_shape),
                         h0=cfg.mean_depth + hp0)
        s = m.segment(s, None, int(round(T / dt)))
        outs[dt] = np.asarray(s.eta_hat)

    ref = outs[1.5]
    errs = [np.linalg.norm(outs[dt] - ref) / np.linalg.norm(ref)
            for dt in (24.0, 12.0, 6.0)]
    assert errs[0] / errs[1] > 10.0, errs
    assert errs[1] / errs[2] > 5.0, errs
    assert errs[2] < 2e-6, errs
