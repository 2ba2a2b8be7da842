"""Sharded barotropic model — the multi-device stepping path.

The reference is strictly serial (SURVEY.md §2 "zero parallelism of any
kind"); this module is the new first-class distributed component mandated by
BASELINE.json: the full RK4 step runs under `shard_map` over a 1-D device
mesh with the grid slab-decomposed by x rows, FFTs from parallel/dfft.py
(all_to_all transposes, which XLA hands to NCCL on GPUs), and every
spectral pointwise operator
acting on its local row slice of the coefficient tables. The whole
`record_step`-long segment is one jitted lax.scan inside the shard_map, so
a multi-device run round-trips to Python only at record points — identical
cadence to the single-device runner.

Usage:
    mesh = make_mesh(jax.devices())
    m = ShardedBarotropicModel.build(cfg, mesh)
    z = m.shard_spectral(model_single.init_state(vort0))
    z = m.segment(z, src, n_steps)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.4.35 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..config import ModelConfig
from ..models import barotropic
from ..ops.spectral import SpectralTables
from . import dfft

AXIS = "x"  # mesh axis name for the slab (row) decomposition


def make_mesh(devices: Optional[Sequence] = None, axis: str = AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices for slab decomposition."""
    devices = list(devices if devices is not None else jax.devices())
    import numpy as np
    return Mesh(np.array(devices), axis_names=(axis,))


def make_mesh2d(shape, devices: Optional[Sequence] = None,
                axes=("host", "chip")) -> Mesh:
    """2-D mesh (e.g. hosts x chips-per-host) for multi-host runs.

    With build(..., axis=axes) the slab/xpencil transposes run over the
    FLATTENED axis pair; what the 2-D mesh buys there is placement: XLA
    decomposes the tuple-axis all_to_all hierarchically so the
    intra-host stage stays on the host's links and only the residual
    crosses hosts. decomp='pencil' uses the two axes as its 2-D pencil
    grid.
    """
    devices = list(devices if devices is not None else jax.devices())
    import numpy as np
    return Mesh(np.array(devices).reshape(shape), axis_names=tuple(axes))


def axis_size(mesh: Mesh, axis) -> int:
    """Total shard count along a (possibly tuple) mesh axis spec."""
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _xpencil_setup(cfg: ModelConfig, mesh: Mesh, axis):
    """Shared build pieces for decomp='xpencil' (parallel/xpencil.py):
    (padded tables, fwd, inv, tspec, sspec, pspec, hpad)."""
    from . import pencil, xpencil
    n = axis_size(mesh, axis)
    if cfg.nx % n != 0:
        raise ValueError(
            f"nx={cfg.nx} not divisible by mesh axis {axis!r} size {n}")
    hny = cfg.ny // 2 + 1
    hpad = pencil.padded_half(hny, n)
    t = pencil.pad_tables(SpectralTables.from_config(cfg), hpad)
    fwd, inv = xpencil.make_fft_pair(axis, n, hny)
    return (t, fwd, inv, xpencil.table_specs(axis),
            xpencil.state_spec(axis), xpencil.phys_spec(axis), hpad)


def _decomp_setup(cfg: ModelConfig, mesh: Mesh, axis, decomp: str):
    """Shared build pieces for every sharded family:
    (tables, fwd, inv, tspec, spec1, pspec, hpad, axis) where spec1 is
    the per-array spectral PartitionSpec (pencil/xpencil modes pad the
    half axis to hpad and column-shard)."""
    if decomp == "pencil":
        from . import pencil
        axes = tuple(mesh.axis_names)
        if len(axes) != 2:
            raise ValueError(
                f"decomp='pencil' needs a 2-D mesh, got axes {axes}")
        pxn, pyn = mesh.shape[axes[0]], mesh.shape[axes[1]]
        pencil.check_grid(cfg.nx, cfg.ny, pxn, pyn)
        hny = cfg.ny // 2 + 1
        hpad = pencil.padded_half(hny, pxn * pyn)
        t = pencil.pad_tables(SpectralTables.from_config(cfg), hpad)
        fwd, inv = pencil.make_fft_pair(axes, (pxn, pyn), hny)
        return (t, fwd, inv, pencil.table_specs(axes),
                pencil.state_spec(axes), pencil.phys_spec(axes), hpad,
                axes)
    if decomp == "xpencil":
        (t, fwd, inv, tspec, spec1, pspec,
         hpad) = _xpencil_setup(cfg, mesh, axis)
        return t, fwd, inv, tspec, spec1, pspec, hpad, axis
    if decomp == "slab":
        n = axis_size(mesh, axis)
        if cfg.nx % n != 0:
            raise ValueError(
                f"nx={cfg.nx} not divisible by mesh axis {axis!r} "
                f"size {n}")
        t = SpectralTables.from_config(cfg)
        fwd, inv = dfft.make_fft_pair(axis, n)
        return (t, fwd, inv, table_specs(axis), P(axis, None),
                P(axis, None), None, axis)
    raise ValueError(f"unknown decomp: {decomp!r}")


def table_specs(axis=AXIS) -> SpectralTables:
    """PartitionSpec pytree for SpectralTables: row-sharded 2-D tables,
    row-sharded kx, replicated (half-axis) ky. `axis` may be a tuple of
    mesh axis names (multi-host flattened sharding)."""
    return SpectralTables(kx=P(axis), ky=P(),
                          lap=P(axis, None), inv_lap=P(axis, None),
                          mask=P(axis, None), rlap=P(axis, None))


@dataclasses.dataclass(frozen=True)
class ShardedBarotropicModel:
    """Multi-device analogue of models.barotropic.BarotropicModel.

    `step`:    (zeta_hat, src) -> zeta_hat, one RK4 step, fully sharded.
    `segment`: (zeta_hat, src, n_steps) -> zeta_hat after n_steps (scan
               inside shard_map; forcing held fixed over the segment).
    `diags`:   zeta_hat -> DiagFields, all sharded like the state.
    """

    cfg: ModelConfig
    mesh: Mesh
    axis: object  # mesh axis name or tuple of names
    tables: SpectralTables
    step: Callable
    segment: Callable
    diags: Callable

    decomp: str = "slab"
    hpad: Optional[int] = None  # padded half-axis width (pencil/xpencil)

    @classmethod
    def build(cls, cfg: ModelConfig, mesh: Mesh,
              axis: str = AXIS,
              decomp: str = "slab") -> "ShardedBarotropicModel":
        g = cfg.grid_shape
        dt, nu = float(cfg.dt), float(cfg.nu)
        r_drag = float(cfg.r_drag)
        beta = float(cfg.beta)
        nu4 = float(cfg.nu4)
        (t, fwd, inv, tspec, sspec, pspec, hpad,
         axis) = _decomp_setup(cfg, mesh, axis, decomp)

        if cfg.time_scheme == "etdrk4":
            # scalar-table ETDRK4 (models/etdrk4.py scalar-family
            # section): the (nx, hny[pad]) phi tables shard exactly
            # like the lap table (pad modes get identity propagators /
            # zero weights, so padded states stay zero); N runs the
            # decomp's distributed transforms inside shard_map.
            from ..models import etdrk4 as etd_mod
            from ..ops import spectral as sp
            hny = cfg.ny // 2 + 1
            etabs = etd_mod.build_scalar_tables(
                cfg, dt, kind="barotropic",
                hpad=hpad if hpad and hpad > hny else 0)
            espec = etd_mod.ScalarEtdTables(*([tspec.lap] * 6))

            def _eN(tl, src, z):
                return sp.dealias(tl, barotropic.tendency(
                    tl, z, src, nu=0.0, grid_shape=g, fwd=fwd,
                    inv=inv))

            def estep_local(et, tl, zeta_hat, src):
                return etd_mod.etd_scheme(
                    functools.partial(_eN, tl, src),
                    lambda T, x: T * x, et, zeta_hat)

            estep_sm = shard_map(estep_local, mesh=mesh,
                                 in_specs=(espec, tspec, sspec, pspec),
                                 out_specs=sspec)
            step = jax.jit(functools.partial(estep_sm, etabs, t))

            @functools.partial(jax.jit, static_argnames=("n_steps",))
            def segment(zeta_hat, src, n_steps: int):
                def seg_local(et, tl, z, src):
                    def body(zz, _):
                        return etd_mod.etd_scheme(
                            functools.partial(_eN, tl, src),
                            lambda T, x: T * x, et, zz), None
                    z, _ = jax.lax.scan(body, z, None, length=n_steps)
                    return z
                return shard_map(seg_local, mesh=mesh,
                                 in_specs=(espec, tspec, sspec, pspec),
                                 out_specs=sspec)(etabs, t, zeta_hat, src)
        else:
            def step_local(tl, zeta_hat, src):
                return barotropic.rk4_step(tl, zeta_hat, src, dt, nu, g,
                                           fwd=fwd, inv=inv,
                                           r_drag=r_drag,
                                           beta=beta, nu4=nu4)

            def segment_local(tl, zeta_hat, src, n_steps: int):
                def body(z, _):
                    return barotropic.rk4_step(tl, z, src, dt, nu, g,
                                               fwd=fwd, inv=inv,
                                               r_drag=r_drag,
                                               beta=beta, nu4=nu4), None
                z, _ = jax.lax.scan(body, zeta_hat, None,
                                    length=n_steps)
                return z

            step_sm = shard_map(step_local, mesh=mesh,
                                in_specs=(tspec, sspec, pspec),
                                out_specs=sspec)
            step = jax.jit(functools.partial(step_sm, t))

            @functools.partial(jax.jit, static_argnames=("n_steps",))
            def segment(zeta_hat, src, n_steps: int):
                local = shard_map(
                    functools.partial(segment_local, n_steps=n_steps),
                    mesh=mesh, in_specs=(tspec, sspec, pspec),
                    out_specs=sspec)
                return local(t, zeta_hat, src)

        def diags_local(tl, zeta_hat):
            return barotropic.diag_fields(tl, zeta_hat, g, inv=inv)

        diags_sm = shard_map(diags_local, mesh=mesh,
                             in_specs=(tspec, sspec),
                             out_specs=barotropic.DiagFields(
                                 vort=pspec, psi=pspec, u=pspec, v=pspec))

        diags = jax.jit(functools.partial(diags_sm, t))

        return cls(cfg=cfg, mesh=mesh, axis=axis, tables=t,
                   step=step, segment=segment, diags=diags,
                   decomp=decomp, hpad=hpad)

    # ----- sharding helpers -----
    def _padded(self) -> bool:
        return self.decomp in ("pencil", "xpencil")

    def _spectral_sharding(self) -> NamedSharding:
        if self.decomp == "pencil":
            from . import pencil
            return NamedSharding(self.mesh,
                                 pencil.state_spec(self.axis))
        if self.decomp == "xpencil":
            from . import xpencil
            return NamedSharding(self.mesh, xpencil.state_spec(self.axis))
        return NamedSharding(self.mesh, P(self.axis, None))

    def _physical_sharding(self) -> NamedSharding:
        if self.decomp == "pencil":
            from . import pencil
            return NamedSharding(self.mesh, pencil.phys_spec(self.axis))
        return NamedSharding(self.mesh, P(self.axis, None))

    def shard_spectral(self, zeta_hat) -> jax.Array:
        """Place a (nx, hny) spectral state on the mesh (pencil/xpencil
        modes pad the half axis to hpad and column-shard)."""
        import numpy as np
        z = np.asarray(zeta_hat, np.complex64)
        if self._padded():
            from . import pencil
            z = pencil.pad_spectral(z, self.hpad)
        return jax.device_put(jnp.asarray(z), self._spectral_sharding())

    def unshard_spectral(self, zeta_hat) -> "object":
        """Sharded state -> host (nx, hny) ndarray (pad stripped),
        gathered across processes when not fully addressable."""
        from . import multihost
        import numpy as np
        z = np.asarray(multihost.gather_to_host(zeta_hat))
        if self._padded():
            from . import pencil
            z = pencil.strip_spectral(z, self.cfg.ny // 2 + 1)
        return z

    def shard_physical(self, field) -> jax.Array:
        """Place a (nx, ny) physical field on the mesh."""
        return jax.device_put(jnp.asarray(field, jnp.float32),
                              self._physical_sharding())

    def init_state(self, vort0) -> jax.Array:
        """Physical IC -> sharded spectral state via the distributed FFT."""
        if self.decomp == "pencil":
            from . import pencil
            axes = self.axis
            pxn = self.mesh.shape[axes[0]]
            pyn = self.mesh.shape[axes[1]]
            fwd, _ = pencil.make_fft_pair(axes, (pxn, pyn),
                                          self.cfg.ny // 2 + 1)
            f = shard_map(fwd, mesh=self.mesh,
                          in_specs=pencil.phys_spec(axes),
                          out_specs=pencil.state_spec(axes))
        elif self.decomp == "xpencil":
            from . import xpencil
            n = axis_size(self.mesh, self.axis)
            fwd, _ = xpencil.make_fft_pair(self.axis, n,
                                           self.cfg.ny // 2 + 1)
            f = shard_map(fwd, mesh=self.mesh,
                          in_specs=xpencil.phys_spec(self.axis),
                          out_specs=xpencil.state_spec(self.axis))
        else:
            n = axis_size(self.mesh, self.axis)
            fwd, _ = dfft.make_fft_pair(self.axis, n)
            f = shard_map(fwd, mesh=self.mesh,
                          in_specs=P(self.axis, None),
                          out_specs=P(self.axis, None))
        return jax.jit(f)(self.shard_physical(vort0))

    def zero_source(self) -> jax.Array:
        return self.shard_physical(
            jnp.zeros(self.cfg.grid_shape, jnp.float32))


@dataclasses.dataclass(frozen=True)
class ShardedShallowWaterModel:
    """Multi-device shallow-water stepper (models/shallow_water.py sharded
    exactly like ShardedBarotropicModel: slab rows, distributed FFTs)."""

    cfg: ModelConfig
    mesh: Mesh
    axis: object  # mesh axis name or tuple of names
    tables: SpectralTables
    step: Callable
    segment: Callable
    diags: Callable

    decomp: str = "slab"
    hpad: Optional[int] = None  # padded half-axis width (pencil/xpencil)

    @classmethod
    def build(cls, cfg: ModelConfig, mesh: Mesh,
              axis: str = AXIS,
              decomp: str = "slab") -> "ShardedShallowWaterModel":
        from ..models import shallow_water as sw

        g = cfg.grid_shape
        dt, nu = float(cfg.dt), float(cfg.nu)
        f, grav = float(cfg.f), float(cfg.gravity)
        H = float(cfg.mean_depth)
        r_drag = float(cfg.r_drag)
        if float(cfg.beta) != 0.0:
            raise NotImplementedError(
                "beta-plane is barotropic/tracer-only: shallow water "
                "needs the spatially varying f inside curl(f u)/div(f u) "
                "(config.py beta note)")
        (t, fwd, inv, tspec, spec1, pspec, hpad,
         axis) = _decomp_setup(cfg, mesh, axis, decomp)
        sspec = sw.SWState(zeta_hat=spec1, div_hat=spec1, eta_hat=spec1)

        nu4 = float(cfg.nu4)

        if cfg.time_scheme == "etdrk4":
            # ETDRK4 sharded: the per-mode 3x3 phi tables are spectral
            # planes like lap/mask, so each (3, 3, nx, hny[pad]) table
            # shards with two leading replicated axes on top of the
            # lap spec (pencil/xpencil layouts pad the half axis; the
            # tables pad to match — mask pads 0, so pad modes get
            # identity propagators and the padded state stays zero).
            # N runs the decomp's distributed transforms inside
            # shard_map exactly like the RK4 path.
            from ..models import etdrk4 as etd_mod
            hny = cfg.ny // 2 + 1
            etabs = etd_mod.build_tables_cached(
                cfg, dt, hpad=hpad if hpad and hpad > hny else 0)
            tab1 = P(None, None, *tuple(tspec.lap))
            espec = etd_mod.SWEtdTables(*([tab1] * 6))

            def estep_local(et, tl, s, src):
                return etd_mod.etdrk4_step(tl, et, s, src, g,
                                           fwd=fwd, inv=inv)

            estep_sm = shard_map(estep_local, mesh=mesh,
                                 in_specs=(espec, tspec, sspec, pspec),
                                 out_specs=sspec)
            step = jax.jit(functools.partial(estep_sm, etabs, t))

            @functools.partial(jax.jit, static_argnames=("n_steps",))
            def segment(s, src, n_steps: int):
                def seg_local(et, tl, s, src):
                    def body(state, _):
                        return etd_mod.etdrk4_step(
                            tl, et, state, src, g, fwd=fwd,
                            inv=inv), None
                    out, _ = jax.lax.scan(body, s, None,
                                          length=n_steps)
                    return out
                return shard_map(seg_local, mesh=mesh,
                                 in_specs=(espec, tspec, sspec, pspec),
                                 out_specs=sspec)(etabs, t, s, src)
        else:
            def step_local(tl, s, src):
                return sw.rk4_step(tl, s, src, dt, f, grav, nu, H, g,
                                   fwd=fwd, inv=inv, r_drag=r_drag,
                                   nu4=nu4)

            step_sm = shard_map(step_local, mesh=mesh,
                                in_specs=(tspec, sspec, pspec),
                                out_specs=sspec)
            step = jax.jit(functools.partial(step_sm, t))

            @functools.partial(jax.jit, static_argnames=("n_steps",))
            def segment(s, src, n_steps: int):
                def seg_local(tl, s, src):
                    def body(state, _):
                        return sw.rk4_step(tl, state, src, dt, f, grav,
                                           nu, H, g, fwd=fwd, inv=inv,
                                           r_drag=r_drag,
                                           nu4=nu4), None
                    out, _ = jax.lax.scan(body, s, None,
                                          length=n_steps)
                    return out
                return shard_map(seg_local, mesh=mesh,
                                 in_specs=(tspec, sspec, pspec),
                                 out_specs=sspec)(t, s,
                                                                 src)

        def diags_local(tl, s):
            u_hat, v_hat = sw.sw_velocities(tl, s.zeta_hat, s.div_hat)
            from ..ops import spectral as sp
            psi_hat = sp.invert_laplacian(tl, s.zeta_hat)
            return sw.SWDiagFields(
                vort=inv(s.zeta_hat, g), div=inv(s.div_hat, g),
                h=H + inv(s.eta_hat, g), u=inv(u_hat, g), v=inv(v_hat, g),
                psi=inv(psi_hat, g))

        dspec = sw.SWDiagFields(vort=pspec, div=pspec, h=pspec,
                                u=pspec, v=pspec, psi=pspec)
        diags_sm = shard_map(diags_local, mesh=mesh,
                             in_specs=(tspec, sspec), out_specs=dspec)
        diags = jax.jit(functools.partial(diags_sm, t))

        return cls(cfg=cfg, mesh=mesh, axis=axis, tables=t,
                   step=step, segment=segment, diags=diags,
                   decomp=decomp, hpad=hpad)

    def _padded(self) -> bool:
        return self.decomp in ("pencil", "xpencil")

    def _spectral_sharding(self) -> NamedSharding:
        if self.decomp == "pencil":
            from . import pencil
            return NamedSharding(self.mesh, pencil.state_spec(self.axis))
        if self.decomp == "xpencil":
            from . import xpencil
            return NamedSharding(self.mesh, xpencil.state_spec(self.axis))
        return NamedSharding(self.mesh, P(self.axis, None))

    def _physical_sharding(self) -> NamedSharding:
        if self.decomp == "pencil":
            from . import pencil
            return NamedSharding(self.mesh, pencil.phys_spec(self.axis))
        return NamedSharding(self.mesh, P(self.axis, None))

    def shard_state(self, s) -> "object":
        if self._padded():
            from . import pencil
            import numpy as np
            from ..models.shallow_water import SWState
            s = SWState(*(jnp.asarray(
                pencil.pad_spectral(np.asarray(a), self.hpad))
                for a in s))
        return jax.device_put(s, self._spectral_sharding())

    def unshard_state(self, s):
        """Sharded SWState -> host SWState of (nx, hny) ndarrays (pad
        stripped), gathered across processes when needed."""
        from . import multihost
        import numpy as np
        from ..models.shallow_water import SWState
        arrs = [np.asarray(multihost.gather_to_host(a)) for a in s]
        if self._padded():
            from . import pencil
            hny = self.cfg.ny // 2 + 1
            arrs = [pencil.strip_spectral(a, hny) for a in arrs]
        return SWState(*arrs)

    def _single(self):
        """Single-device model for IC construction. Pencil/xpencil
        tables are PADDED to hpad columns, so the single model builds
        its own (unpadded) tables there; slab tables are shared."""
        from ..models.shallow_water import ShallowWaterModel
        tables = None if self._padded() else self.tables
        return ShallowWaterModel.build(self.cfg, tables=tables)

    def init_state(self, vort0, div0=None, h0=None):
        """Build the SW state on host via the single-device model's layout,
        then shard (ICs are a one-time cost; the hot path stays on-mesh)."""
        return self.shard_state(self._single().init_state(vort0, div0, h0))

    def geostrophic_init(self, vort0):
        return self.shard_state(self._single().geostrophic_init(vort0))

    def zero_source(self) -> jax.Array:
        return jax.device_put(
            jnp.zeros(self.cfg.grid_shape, jnp.float32),
            self._physical_sharding())


@dataclasses.dataclass(frozen=True)
class ShardedTracerModel:
    """Multi-device passive-tracer family (models/tracer.py sharded exactly
    like the other families: any decomp, distributed FFTs; the joint
    (zeta_hat, q_hat) state is two identically-sharded spectral arrays)."""

    cfg: ModelConfig
    mesh: Mesh
    axis: object
    tables: SpectralTables
    kappa: float
    step: Callable
    segment: Callable
    diags: Callable

    decomp: str = "slab"
    hpad: Optional[int] = None

    @classmethod
    def build(cls, cfg: ModelConfig, mesh: Mesh,
              axis: str = AXIS,
              decomp: str = "slab",
              kappa: float = 0.0) -> "ShardedTracerModel":
        from ..models import tracer as tr

        g = cfg.grid_shape
        dt, nu, kp = float(cfg.dt), float(cfg.nu), float(kappa)
        r_drag = float(cfg.r_drag)
        beta = float(cfg.beta)
        (t, fwd, inv, tspec, spec1, pspec, hpad,
         axis) = _decomp_setup(cfg, mesh, axis, decomp)
        sspec = tr.TracerState(zeta_hat=spec1, q_hat=spec1)

        nu4 = float(cfg.nu4)

        if cfg.time_scheme == "etdrk4":
            # stacked scalar-table ETDRK4 (flow + tracer slots); the
            # (2, nx, hny[pad]) tables shard like lap with one leading
            # replicated axis (see the sharded SW/barotropic notes).
            from ..models import etdrk4 as etd_mod
            from ..ops import spectral as sp
            hny = cfg.ny // 2 + 1
            etabs = etd_mod.build_scalar_tables(
                cfg, dt, kind="tracer", kappa=kp,
                hpad=hpad if hpad and hpad > hny else 0)
            tab1 = P(None, *tuple(tspec.lap))
            espec = etd_mod.ScalarEtdTables(*([tab1] * 6))

            def _eN(tl, src, s):
                d = tr.tendency(tl, s, src, nu=0.0, kappa=0.0,
                                grid_shape=g, fwd=fwd, inv=inv)
                return tr.TracerState(sp.dealias(tl, d.zeta_hat),
                                      sp.dealias(tl, d.q_hat))

            def _emul(T, s):
                return tr.TracerState(T[0] * s.zeta_hat,
                                      T[1] * s.q_hat)

            def estep_local(et, tl, s, src):
                return etd_mod.etd_scheme(
                    functools.partial(_eN, tl, src), _emul, et, s)

            estep_sm = shard_map(estep_local, mesh=mesh,
                                 in_specs=(espec, tspec, sspec, pspec),
                                 out_specs=sspec)
            step = jax.jit(functools.partial(estep_sm, etabs, t))

            @functools.partial(jax.jit, static_argnames=("n_steps",))
            def segment(s, src, n_steps: int):
                def seg_local(et, tl, s, src):
                    def body(state, _):
                        return etd_mod.etd_scheme(
                            functools.partial(_eN, tl, src), _emul,
                            et, state), None
                    out, _ = jax.lax.scan(body, s, None,
                                          length=n_steps)
                    return out
                return shard_map(seg_local, mesh=mesh,
                                 in_specs=(espec, tspec, sspec, pspec),
                                 out_specs=sspec)(etabs, t, s, src)
        else:
            def step_local(tl, s, src):
                return tr.rk4_step(tl, s, src, dt, nu, kp, g, fwd=fwd,
                                   inv=inv, r_drag=r_drag, beta=beta,
                                   nu4=nu4)

            step_sm = shard_map(step_local, mesh=mesh,
                                in_specs=(tspec, sspec, pspec),
                                out_specs=sspec)
            step = jax.jit(functools.partial(step_sm, t))

            @functools.partial(jax.jit, static_argnames=("n_steps",))
            def segment(s, src, n_steps: int):
                def seg_local(tl, s, src):
                    def body(state, _):
                        return tr.rk4_step(tl, state, src, dt, nu, kp,
                                           g, fwd=fwd, inv=inv,
                                           r_drag=r_drag, beta=beta,
                                           nu4=nu4), None
                    out, _ = jax.lax.scan(body, s, None,
                                          length=n_steps)
                    return out
                return shard_map(seg_local, mesh=mesh,
                                 in_specs=(tspec, sspec, pspec),
                                 out_specs=sspec)(t, s,
                                                                 src)

        def diags_local(tl, s):
            from ..ops import spectral as sp
            psi_hat = sp.invert_laplacian(tl, s.zeta_hat)
            u_hat, v_hat = sp.velocities(tl, psi_hat)
            return tr.TracerDiagFields(
                vort=inv(s.zeta_hat, g), psi=inv(psi_hat, g),
                u=inv(u_hat, g), v=inv(v_hat, g), q=inv(s.q_hat, g))

        dspec = tr.TracerDiagFields(vort=pspec, psi=pspec, u=pspec,
                                    v=pspec, q=pspec)
        diags_sm = shard_map(diags_local, mesh=mesh,
                             in_specs=(tspec, sspec), out_specs=dspec)
        diags = jax.jit(functools.partial(diags_sm, t))

        return cls(cfg=cfg, mesh=mesh, axis=axis, tables=t, kappa=kp,
                   step=step, segment=segment, diags=diags,
                   decomp=decomp, hpad=hpad)

    _padded = ShardedShallowWaterModel._padded
    _spectral_sharding = ShardedShallowWaterModel._spectral_sharding
    _physical_sharding = ShardedShallowWaterModel._physical_sharding

    def shard_state(self, s) -> "object":
        from ..models.tracer import TracerState
        if self._padded():
            from . import pencil
            import numpy as np
            s = TracerState(*(jnp.asarray(
                pencil.pad_spectral(np.asarray(a), self.hpad))
                for a in s))
        else:
            s = TracerState(*(jnp.asarray(a) for a in s))
        return jax.device_put(s, self._spectral_sharding())

    def unshard_state(self, s):
        from . import multihost
        import numpy as np
        from ..models.tracer import TracerState
        arrs = [np.asarray(multihost.gather_to_host(a)) for a in s]
        if self._padded():
            from . import pencil
            hny = self.cfg.ny // 2 + 1
            arrs = [pencil.strip_spectral(a, hny) for a in arrs]
        return TracerState(*arrs)

    def init_state(self, vort0, q0):
        from ..models.tracer import TracerModel
        tables = None if self._padded() else self.tables
        single = TracerModel.build(self.cfg, kappa=self.kappa,
                                   tables=tables)
        return self.shard_state(single.init_state(vort0, q0))

    def zero_source(self) -> jax.Array:
        return jax.device_put(
            jnp.zeros(self.cfg.grid_shape, jnp.float32),
            self._physical_sharding())
