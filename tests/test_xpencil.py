"""x-pencil spectral layout (parallel/xpencil.py) on the 8-virtual-device
CPU mesh and its 2- and 4-device submeshes: one all_to_all per transform
instead of the slab's two.

Strategy per SURVEY.md §4: jnp.fft and the single-device model are the
oracles; the slab path (itself differentially verified) cross-checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.models.barotropic import BarotropicModel
from xlab_fftbarotropic.parallel import xpencil
from xlab_fftbarotropic.parallel.model import (
    ShardedBarotropicModel, ShardedShallowWaterModel, make_mesh)

try:
    shard_map = jax.shard_map
except AttributeError:
    from jax.experimental.shard_map import shard_map

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (virtual) devices")

# mesh sizes: the full 8-device mesh and the 2- and 4-device submeshes
# (4 is the layout of a four-card host)
N_DEV = [2, 4, 8]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices())


def _submesh(n_dev):
    return make_mesh(jax.devices()[:n_dev])


@pytest.mark.parametrize("n_dev", N_DEV)
def test_xpencil_forward_matches_rfft2(rng, n_dev):
    mesh = _submesh(n_dev)
    f = rng.randn(64, 64).astype(np.float32)
    hny = 33
    fwd_l, _ = xpencil.make_fft_pair("x", n_dev, hny)
    fwd = jax.jit(shard_map(fwd_l, mesh=mesh, in_specs=P("x", None),
                            out_specs=P(None, "x")))
    got = np.asarray(fwd(jnp.asarray(f)))
    hpad = -(-hny // n_dev) * n_dev
    assert got.shape == (64, hpad)
    want = np.fft.rfft2(f).astype(np.complex64)
    np.testing.assert_allclose(got[:, :hny], want, rtol=2e-5, atol=1e-3)
    # pad columns are exact zeros
    np.testing.assert_array_equal(got[:, hny:], 0.0)


@pytest.mark.parametrize("n_dev", N_DEV)
def test_xpencil_roundtrip(rng, n_dev):
    mesh = _submesh(n_dev)
    f = rng.randn(64, 64).astype(np.float32)
    fwd_l, inv_l = xpencil.make_fft_pair("x", n_dev, 33)
    run = jax.jit(shard_map(
        lambda a: inv_l(fwd_l(a), (64, 64)), mesh=mesh,
        in_specs=P("x", None), out_specs=P("x", None)))
    back = np.asarray(run(jnp.asarray(f)))
    np.testing.assert_allclose(back, f, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_dev", N_DEV)
def test_xpencil_inverse_matches_irfft2(rng, n_dev):
    """Inverse from a padded x-pencil (pad columns zero) == irfft2."""
    mesh = _submesh(n_dev)
    hny = 33
    hpad = -(-hny // n_dev) * n_dev
    spec = (rng.randn(64, hny)
            + 1j * rng.randn(64, hny)).astype(np.complex64)
    padded = np.pad(spec, ((0, 0), (0, hpad - hny)))
    _, inv_l = xpencil.make_fft_pair("x", n_dev, hny)
    inv = jax.jit(shard_map(
        lambda s: inv_l(s, (64, 64)), mesh=mesh,
        in_specs=P(None, "x"), out_specs=P("x", None)))
    got = np.asarray(inv(jnp.asarray(padded)))
    want = np.fft.irfft2(spec, s=(64, 64)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("n_dev", N_DEV)
def test_xpencil_barotropic_segment_matches_single(n_dev):
    mesh = _submesh(n_dev)
    cfg = ModelConfig(nx=64, ny=64, dt=3.0, nu=6.5)
    vort0 = makefields.gaussian(cfg)
    single = BarotropicModel.build(cfg)
    multi = ShardedBarotropicModel.build(cfg, mesh, decomp="xpencil")
    assert multi.hpad == -(-33 // n_dev) * n_dev

    z1 = single.init_state(vort0)
    zN = multi.init_state(vort0)
    np.testing.assert_allclose(
        multi.unshard_spectral(zN), np.asarray(z1), rtol=2e-5, atol=1e-4)

    steps = 5
    z1 = single.segment(z1, single.zero_source(), steps)
    zN = multi.segment(zN, multi.zero_source(), steps)
    np.testing.assert_allclose(
        multi.unshard_spectral(zN), np.asarray(z1), rtol=5e-5, atol=5e-4)


def test_xpencil_matches_slab_trajectory(mesh):
    """Same mesh, same steps: x-pencil (1 a2a/transform) == slab
    (2 a2as/transform) to float round-off."""
    cfg = ModelConfig(nx=64, ny=64, dt=3.0, nu=6.5)
    vort0 = makefields.kuo2004(cfg)
    slab = ShardedBarotropicModel.build(cfg, mesh)
    xp = ShardedBarotropicModel.build(cfg, mesh, decomp="xpencil")
    z_s = slab.segment(slab.init_state(vort0), slab.zero_source(), 5)
    z_x = xp.segment(xp.init_state(vort0), xp.zero_source(), 5)
    np.testing.assert_allclose(
        xp.unshard_spectral(z_x), np.asarray(z_s), rtol=5e-5, atol=5e-4)


def test_xpencil_sw_segment_matches_single(mesh):
    from xlab_fftbarotropic.models.shallow_water import (
        ShallowWaterModel)
    cfg = ModelConfig(nx=64, ny=64, dt=1.0)
    vort0 = makefields.gaussian(cfg, zeta0=1e-5)
    single = ShallowWaterModel.build(cfg)
    multi = ShardedShallowWaterModel.build(cfg, mesh, decomp="xpencil")
    s1 = single.geostrophic_init(vort0)
    sN = multi.geostrophic_init(vort0)

    steps = 5
    s1 = single.segment(s1, single.zero_source(), steps)
    sN = multi.segment(sN, multi.zero_source(), steps)
    got = multi.unshard_state(sN)
    # div is the small residual of cancelling zeta-scale terms; its
    # round-off floor is set by the zeta-scale dynamics (same policy as
    # tests/test_pencil.py) — normalize it by the zeta scale
    zscale = max(np.abs(np.asarray(s1.zeta_hat)).max(), 1e-30)
    for a, b, name in ((got.zeta_hat, s1.zeta_hat, "zeta"),
                       (got.div_hat, s1.div_hat, "div"),
                       (got.eta_hat, s1.eta_hat, "eta")):
        b = np.asarray(b)
        scale = zscale if name == "div" else max(np.abs(b).max(), 1e-30)
        err = np.abs(np.asarray(a) - b).max() / scale
        assert err < 1e-4, (name, err)


def test_xpencil_diags_match_single(mesh):
    cfg = ModelConfig(nx=64, ny=64)
    vort0 = makefields.elliptic_vortex(cfg)
    single = BarotropicModel.build(cfg)
    multi = ShardedBarotropicModel.build(cfg, mesh, decomp="xpencil")
    d1 = single.diags(single.init_state(vort0))
    dN = multi.diags(multi.init_state(vort0))
    for a, b in zip(dN, d1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=1e-4)


def test_xpencil_2d_mesh_multihost_layout():
    """Flattened ('host','chip') x-pencil with XLA collectives matches
    the single-device model — the multi-host halved-traffic layout on a
    virtual 2x4 mesh (tuple-axis all_to_all decomposes hierarchically)."""
    from xlab_fftbarotropic.parallel import make_mesh2d
    cfg = ModelConfig(nx=64, ny=64)
    vort0 = makefields.gaussian(cfg)
    mesh2 = make_mesh2d((2, 4))
    multi2 = ShardedBarotropicModel.build(cfg, mesh2,
                                          axis=("host", "chip"),
                                          decomp="xpencil")
    single = BarotropicModel.build(cfg)
    z2 = multi2.segment(multi2.init_state(vort0),
                        multi2.zero_source(), 3)
    z1 = single.segment(single.init_state(vort0),
                        single.zero_source(), 3)
    scale = max(1e-30, float(jnp.max(jnp.abs(z1))))
    np.testing.assert_allclose(
        multi2.unshard_spectral(z2) / scale, np.asarray(z1) / scale,
        rtol=0, atol=5e-5)


def test_xpencil_validation_errors(mesh):
    with pytest.raises(ValueError, match="not divisible"):
        ShardedBarotropicModel.build(ModelConfig(nx=60, ny=64), mesh,
                                     decomp="xpencil")
