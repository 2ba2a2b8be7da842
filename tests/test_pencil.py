"""True pencil (2-D) decomposition tests on a 2x4 virtual CPU mesh.

Differential strategy (SURVEY.md §4): the pencil transforms against
jnp.fft on the same data, the pencil-sharded RK4 segments against the
single-device models (themselves oracle-verified), and against the slab
path. Covers the padded half axis (hny=33 on 64^2 -> hpad=40 over P=8),
the (py, px)-major column ownership, and the pad-stripping state round
trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.models.barotropic import BarotropicModel
from xlab_fftbarotropic.parallel import (ShardedBarotropicModel,
                                             ShardedShallowWaterModel,
                                             make_mesh)
from xlab_fftbarotropic.parallel import pencil

try:
    shard_map = jax.shard_map
except AttributeError:
    from jax.experimental.shard_map import shard_map

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@pytest.fixture(scope="module")
def mesh():
    return pencil.make_pencil_mesh((2, 4))


def _pencil_pair(mesh, nx, ny):
    axes = tuple(mesh.axis_names)
    shape = (mesh.shape[axes[0]], mesh.shape[axes[1]])
    hny = ny // 2 + 1
    fwd_l, inv_l = pencil.make_fft_pair(axes, shape, hny)
    fwd = jax.jit(shard_map(fwd_l, mesh=mesh,
                            in_specs=pencil.phys_spec(axes),
                            out_specs=pencil.state_spec(axes)))
    inv = jax.jit(shard_map(lambda s: inv_l(s, (nx, ny)), mesh=mesh,
                            in_specs=pencil.state_spec(axes),
                            out_specs=pencil.phys_spec(axes)))
    return fwd, inv


def test_pencil_forward_matches_rfft2(mesh, rng):
    """x-pencil spectrum (pad stripped) == np.fft.rfft2; exercises the
    padded half axis: hny=33, P=8 -> hpad=40."""
    nx = ny = 64
    f = rng.randn(nx, ny).astype(np.float32)
    fwd, _ = _pencil_pair(mesh, nx, ny)
    got = np.asarray(fwd(jnp.asarray(f)))
    hny = ny // 2 + 1
    assert got.shape == (nx, pencil.padded_half(hny, 8))
    want = np.fft.rfft2(f).astype(np.complex64)
    np.testing.assert_allclose(got[:, :hny], want, rtol=2e-5, atol=1e-3)
    # pad columns are exact zeros
    assert np.all(got[:, hny:] == 0)


def test_pencil_roundtrip(mesh, rng):
    nx = ny = 64
    f = rng.randn(nx, ny).astype(np.float32)
    fwd, inv = _pencil_pair(mesh, nx, ny)
    back = np.asarray(inv(fwd(jnp.asarray(f))))
    np.testing.assert_allclose(back, f, rtol=1e-5, atol=1e-5)


def test_pencil_matches_slab_fft(mesh, rng):
    """Pencil and slab forward transforms agree on the same data."""
    from xlab_fftbarotropic.parallel import make_fft_pair
    from jax.sharding import PartitionSpec as P

    nx = ny = 64
    f = rng.randn(nx, ny).astype(np.float32)
    fwd_p, _ = _pencil_pair(mesh, nx, ny)
    got_p = np.asarray(fwd_p(jnp.asarray(f)))[:, :ny // 2 + 1]

    slab = make_mesh(jax.devices())
    fwd_l, _ = make_fft_pair("x", 8)
    fwd_s = jax.jit(shard_map(fwd_l, mesh=slab, in_specs=P("x", None),
                              out_specs=P("x", None)))
    got_s = np.asarray(fwd_s(jnp.asarray(f)))
    np.testing.assert_allclose(got_p, got_s, rtol=2e-5, atol=1e-3)


def test_pencil_barotropic_segment_matches_single(mesh):
    """10 sharded RK4 steps under the pencil decomposition track the
    single-device model."""
    cfg = ModelConfig(nx=64, ny=64)
    v0 = makefields.gaussian(cfg)
    single = BarotropicModel.build(cfg)
    z_ref = single.segment(single.init_state(v0), jnp.zeros(
        cfg.grid_shape, jnp.float32), 10)

    m = ShardedBarotropicModel.build(cfg, mesh, decomp="pencil")
    z = m.segment(m.init_state(v0), m.zero_source(), 10)
    got = m.unshard_spectral(z)
    a = np.asarray(jnp.fft.irfft2(z_ref, s=cfg.grid_shape))
    b = np.asarray(jnp.fft.irfft2(jnp.asarray(got), s=cfg.grid_shape))
    assert np.max(np.abs(a - b)) < 1e-6 * max(1.0, np.max(np.abs(a)))


def test_pencil_barotropic_diags_match(mesh):
    cfg = ModelConfig(nx=64, ny=64)
    v0 = makefields.kuo2004(cfg)
    single = BarotropicModel.build(cfg)
    z0 = single.init_state(v0)
    d_ref = single.diags(z0)

    m = ShardedBarotropicModel.build(cfg, mesh, decomp="pencil")
    d = m.diags(m.shard_spectral(np.asarray(z0)))
    for name in ("vort", "psi", "u", "v"):
        a = np.asarray(getattr(d_ref, name))
        b = np.asarray(getattr(d, name))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * max(
            1.0, np.abs(a).max()), err_msg=name)


def test_pencil_sw_segment_matches_single(mesh):
    """Sharded shallow water under the pencil decomposition."""
    from xlab_fftbarotropic.models.shallow_water import (
        ShallowWaterModel)

    cfg = ModelConfig(nx=64, ny=64, dt=1.0)
    v0 = makefields.gaussian(cfg)
    single = ShallowWaterModel.build(cfg)
    s0 = single.geostrophic_init(v0)
    ref = single.segment(s0, jnp.zeros(cfg.grid_shape, jnp.float32), 5)

    m = ShardedShallowWaterModel.build(cfg, mesh, decomp="pencil")
    s = m.shard_state(s0)
    out = m.segment(s, m.zero_source(), 5)
    got = m.unshard_state(out)
    phys = {}
    for name in ("zeta_hat", "div_hat", "eta_hat"):
        a = np.asarray(jnp.fft.irfft2(getattr(ref, name),
                                      s=cfg.grid_shape))
        b = np.asarray(jnp.fft.irfft2(jnp.asarray(getattr(got, name)),
                                      s=cfg.grid_shape))
        phys[name] = (a, b)
    nz = np.max(np.abs(phys["zeta_hat"][0]))
    for name, (a, b) in phys.items():
        # div is the small residual of cancelling zeta-scale terms; its
        # round-off floor is set by the zeta-scale dynamics — normalize
        # it by the shared scale
        norm = nz if name == "div_hat" else np.max(np.abs(a))
        assert np.max(np.abs(a - b)) < 1e-5 * max(1e-9, norm), name


@pytest.mark.parametrize("decomp", ["slab", "xpencil", "pencil"])
def test_p4_sw_segment_matches_single(p4_mesh, decomp):
    """Four devices, every decomposition: the sharded shallow-water
    segment equals the single-device one. eta is compared in relative
    L2; div, the small residual of cancelling zeta-scale terms, is
    normalised by zeta's norm (tests/test_shallow_water.py policy)."""
    from xlab_fftbarotropic.models.shallow_water import (
        ShallowWaterModel)

    cfg = ModelConfig(nx=64, ny=64, dt=1.0)
    v0 = makefields.gaussian(cfg, zeta0=1e-5)
    single = ShallowWaterModel.build(cfg)
    ref = single.segment(single.geostrophic_init(v0),
                         single.zero_source(), 4)
    m = ShardedShallowWaterModel.build(cfg, p4_mesh(decomp), decomp=decomp)
    got = m.unshard_state(m.segment(m.geostrophic_init(v0),
                                    m.zero_source(), 4))
    nz = np.linalg.norm(np.asarray(ref.zeta_hat))
    for name in ("zeta_hat", "div_hat", "eta_hat"):
        a = np.asarray(getattr(got, name))
        b = np.asarray(getattr(ref, name))
        norm = nz if name == "div_hat" else np.linalg.norm(b)
        rel = np.linalg.norm(a - b) / max(norm, 1e-30)
        assert rel < 1e-5, (name, rel)


def test_pencil_state_roundtrip_strips_pad(mesh):
    cfg = ModelConfig(nx=64, ny=64)
    m = ShardedBarotropicModel.build(cfg, mesh, decomp="pencil")
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((64, 33))
         + 1j * rng.standard_normal((64, 33))).astype(np.complex64)
    out = m.unshard_spectral(m.shard_spectral(z))
    assert out.shape == (64, 33)
    np.testing.assert_array_equal(out, z)


def test_pencil_validation_errors(mesh):
    cfg = ModelConfig(nx=60, ny=64)   # 60 not divisible by 8
    with pytest.raises(ValueError, match="divisible"):
        ShardedBarotropicModel.build(cfg, mesh, decomp="pencil")
    cfg2 = ModelConfig(nx=64, ny=64)
    # the distributed transform is XLA's all_to_all alone: no option
    # selects another implementation
    with pytest.raises(TypeError, match="fft_impl"):
        ShardedBarotropicModel.build(cfg2, mesh, decomp="pencil",
                                     fft_impl="pallas")
    slab = make_mesh(jax.devices())
    with pytest.raises(ValueError, match="2-D mesh"):
        ShardedBarotropicModel.build(cfg2, slab, decomp="pencil")
