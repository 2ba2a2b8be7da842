"""Distributed (multi-chip) path tests on an 8-virtual-device CPU mesh.

Strategy per SURVEY.md §4: the single-device path (itself differentially
verified against the CPU oracle) is the oracle for the distributed path —
distributed FFT vs jnp.fft on the same data, sharded RK4 steps vs the
single-device model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.models.barotropic import BarotropicModel
from xlab_fftbarotropic.parallel import (
    ShardedBarotropicModel, make_mesh, make_fft_pair)

try:
    shard_map = jax.shard_map
except AttributeError:
    from jax.experimental.shard_map import shard_map

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (virtual) devices")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices())


def _sharded_fft_pair(mesh):
    n = mesh.shape["x"]
    fwd_l, inv_l = make_fft_pair("x", n)
    fwd = jax.jit(shard_map(fwd_l, mesh=mesh, in_specs=P("x", None),
                            out_specs=P("x", None)))
    inv = jax.jit(shard_map(lambda s: inv_l(s, None), mesh=mesh,
                            in_specs=P("x", None), out_specs=P("x", None)))
    return fwd, inv


def test_dfft_forward_matches_rfft2(mesh, rng):
    f = rng.randn(64, 48).astype(np.float32)
    fwd, _ = _sharded_fft_pair(mesh)
    got = np.asarray(fwd(jnp.asarray(f)))
    want = np.fft.rfft2(f).astype(np.complex64)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-3)


def test_dfft_roundtrip(mesh, rng):
    f = rng.randn(64, 64).astype(np.float32)
    fwd, inv = _sharded_fft_pair(mesh)
    back = np.asarray(inv(fwd(jnp.asarray(f))))
    np.testing.assert_allclose(back, f, rtol=1e-5, atol=1e-5)


def test_dfft_inverse_matches_irfft2(mesh, rng):
    spec = (rng.randn(64, 33) + 1j * rng.randn(64, 33)).astype(np.complex64)
    _, inv = _sharded_fft_pair(mesh)
    got = np.asarray(inv(jnp.asarray(spec)))
    want = np.fft.irfft2(spec, s=(64, 64)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


def test_sharded_step_matches_single_device(mesh):
    cfg = ModelConfig(nx=64, ny=64, dt=3.0, nu=6.5)
    vort0 = makefields.gaussian(cfg)
    single = BarotropicModel.build(cfg)
    multi = ShardedBarotropicModel.build(cfg, mesh)

    z1 = single.init_state(vort0)
    zN = multi.init_state(vort0)
    np.testing.assert_allclose(np.asarray(zN), np.asarray(z1),
                               rtol=2e-5, atol=1e-4)

    s1, sN = single.zero_source(), multi.zero_source()
    for _ in range(3):
        z1 = single.step(z1, s1)
        zN = multi.step(zN, sN)
    scale = max(1e-30, float(jnp.max(jnp.abs(z1))))
    np.testing.assert_allclose(np.asarray(zN) / scale,
                               np.asarray(z1) / scale,
                               rtol=0, atol=2e-5)


def test_sharded_segment_matches_stepped(mesh):
    cfg = ModelConfig(nx=64, ny=64)
    vort0 = makefields.kuo2004(cfg)
    multi = ShardedBarotropicModel.build(cfg, mesh)
    z0 = multi.init_state(vort0)
    src = multi.zero_source()
    z_seg = multi.segment(z0, src, 4)
    z_it = z0
    for _ in range(4):
        z_it = multi.step(z_it, src)
    np.testing.assert_allclose(np.asarray(z_seg), np.asarray(z_it),
                               rtol=2e-5, atol=1e-6)


def test_sharded_diags_match_single(mesh):
    cfg = ModelConfig(nx=64, ny=64)
    vort0 = makefields.elliptic_vortex(cfg)
    single = BarotropicModel.build(cfg)
    multi = ShardedBarotropicModel.build(cfg, mesh)
    d1 = single.diags(single.init_state(vort0))
    dN = multi.diags(multi.init_state(vort0))
    for a, b in zip(dN, d1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)


def test_sharded_state_layout(mesh):
    cfg = ModelConfig(nx=64, ny=64)
    multi = ShardedBarotropicModel.build(cfg, mesh)
    z = multi.init_state(makefields.gaussian(cfg))
    shard_rows = {s.index[0] for s in z.addressable_shards}
    assert len(shard_rows) == mesh.shape["x"]


def test_sharded_shallow_water_matches_single(mesh):
    from xlab_fftbarotropic.models.shallow_water import ShallowWaterModel
    from xlab_fftbarotropic.parallel import ShardedShallowWaterModel
    cfg = ModelConfig(nx=64, ny=64, nu=0.0, gravity=9.81, mean_depth=1000.0)
    vort0 = makefields.gaussian(cfg, zeta0=1e-5)
    single = ShallowWaterModel.build(cfg)
    multi = ShardedShallowWaterModel.build(cfg, mesh)
    s1 = single.geostrophic_init(vort0)
    sN = multi.geostrophic_init(vort0)
    src1 = single.zero_source()
    srcN = multi.zero_source()
    for _ in range(3):
        s1 = single.step(s1, src1)
        sN = multi.step(sN, srcN)
    # one COMMON scale across the state: the single path uses Hermitian-
    # paired c2c transforms, the distributed path r2c+all_to_all, so
    # per-field normalization of near-zero fields (div starts at 0) would
    # amplify harmless algorithm-difference rounding into false failures.
    scale = max(float(np.max(np.abs(np.asarray(f)))) for f in s1)
    for a, b in zip(sN, s1):
        np.testing.assert_allclose(np.asarray(a) / scale,
                                   np.asarray(b) / scale,
                                   rtol=0, atol=5e-5)


@pytest.mark.parametrize("decomp", ["slab", "xpencil", "pencil"])
def test_p4_barotropic_segment_matches_single(p4_mesh, decomp):
    """Four devices, every decomposition: the sharded barotropic segment
    equals the single-device one (the four-card layout)."""
    cfg = ModelConfig(nx=64, ny=64, dt=3.0, nu=6.5)
    vort0 = makefields.kuo2004(cfg)
    single = BarotropicModel.build(cfg)
    multi = ShardedBarotropicModel.build(cfg, p4_mesh(decomp),
                                         decomp=decomp)
    z1 = single.segment(single.init_state(vort0), single.zero_source(), 4)
    zN = multi.segment(multi.init_state(vort0), multi.zero_source(), 4)
    a, b = multi.unshard_spectral(zN), np.asarray(z1)
    rel = np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel < 1e-5, rel


def test_2d_mesh_multihost_layout():
    """Flattened ('host','chip') sharding matches the 1-D slab result —
    the multi-host path on a virtual 2x4 mesh."""
    from xlab_fftbarotropic.parallel import make_mesh2d
    cfg = ModelConfig(nx=64, ny=64)
    vort0 = makefields.gaussian(cfg)
    mesh2 = make_mesh2d((2, 4))
    multi2 = ShardedBarotropicModel.build(cfg, mesh2,
                                          axis=("host", "chip"))
    single = BarotropicModel.build(cfg)
    z2 = multi2.init_state(vort0)
    z1 = single.init_state(vort0)
    src2, src1 = multi2.zero_source(), single.zero_source()
    for _ in range(2):
        z2 = multi2.step(z2, src2)
        z1 = single.step(z1, src1)
    scale = max(1e-30, float(jnp.max(jnp.abs(z1))))
    np.testing.assert_allclose(np.asarray(z2) / scale,
                               np.asarray(z1) / scale, rtol=0, atol=2e-5)


def test_multihost_initialize_noop_single_process():
    """No coordinator config -> no-op False; rank 0 owns I/O."""
    from xlab_fftbarotropic.parallel import multihost

    assert multihost.initialize() is False
    assert multihost.is_primary()
