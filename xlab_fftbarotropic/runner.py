"""Run orchestration: the time loop of main.cpp / main-shallow-water.cpp.

Structure: the reference executes 20 serial FFTs per step in one
thread with per-step printf; here the hot path is a single jitted lax.scan
over `record_step` RK4 steps (no host round-trips between record points).
Host work happens only at segment boundaries: field records, manifest lines,
per-step scalars, checkpoints, and forcing updates.

Forcing interaction (SURVEY.md §3.2): the reference reads the source stream
once per step BEFORE the RK backup (main-shallow-water.cpp:304). FIFO mode
therefore steps one step at a time (each step is still one jitted call; the
blocking 1-byte flag read is overlapped with the device step by dispatching
the step before the next protocol read is consumed). EMPTY/SCRIPT modes use
full-segment scans, with SCRIPT splitting segments at recipe times.
"""

from __future__ import annotations

import dataclasses
import sys
import time as _time
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import ModelConfig
from .forcing.source import SourceReader, make_reader
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.fieldio import FieldRecorder, Manifest, read_field
from .models.barotropic import BarotropicModel
from .parallel.multihost import gather_to_host as _np
from .parallel.multihost import is_primary


@dataclasses.dataclass
class RunResult:
    zeta_hat: jax.Array        # barotropic: spectral state; SW: SWState
    steps_run: int
    wall_time: float
    stats_history: list


def _gather_fields(fields: dict, only=None) -> dict:
    """Gather the requested subset of record fields to host numpy.

    only=None gathers everything (the reference's full record set);
    only=iterable keeps just those names — with --record-fields the
    device→host transfer (one 4096² field is 67 MB) shrinks to the
    fields the downstream pipeline actually reads. Unknown names are an error so a
    typo cannot silently drop a record stream."""
    if only is not None:
        want = set(only) - {"vort_src"}
        unknown = want - set(fields)
        if unknown:
            raise ValueError(
                f"--record-fields: unknown field(s) {sorted(unknown)}; "
                f"this model records {sorted(fields)} (+ vort_src)")
        fields = {k: v for k, v in fields.items() if k in want}
    return {k: _np(v) for k, v in fields.items()}


class _BarotropicAdapter:
    """Uniform facade the run loop drives: step/segment/diags/stats +
    state (de)hydration. Keeps the loop model-agnostic."""

    kind = "barotropic"

    def __init__(self, cfg, model=None):
        self.cfg = cfg
        self.model = model or BarotropicModel.build(cfg)

    def init_from_physical(self, vort0):
        return self.model.init_state(vort0)

    def step(self, state, src):
        return self.model.step(state, src)

    def segment(self, state, src, n):
        return self.model.segment(state, src, n)

    def record_fields(self, state, only=None):
        d = self.model.diags(state)
        return _gather_fields(dict(vort=d.vort, psi=d.psi,
                                   u=d.u, v=d.v), only)

    def debug_record_fields(self, state, src):
        """--debug-fields dumps (main.cpp OUTPUT_GRAD_VORT/OUTPUT_DVORTDT)."""
        if getattr(self.model, "debug", None) is None:
            raise ValueError(
                "--debug-fields is not supported by this model build "
                f"({type(self.model).__name__} has no debug diagnostics)")
        d = self.model.debug(state, src)
        return dict(dvortdx=_np(d.dvortdx), dvortdy=_np(d.dvortdy),
                    dvortdt=_np(d.dvortdt))

    def stats(self, state):
        if not hasattr(self.model, "stats"):   # sharded models: skip
            return {}
        s = self.model.stats(state)
        return dict(max_abs_vort=float(s.max_abs_vort),
                    energy=float(s.energy),
                    enstrophy=float(s.enstrophy), cfl=float(s.cfl))

    def pack(self, state):
        if hasattr(self.model, "unshard_spectral"):
            # sharded models: gather (multi-process safe) and strip any
            # pencil pad so checkpoints are layout-independent
            return self.model.unshard_spectral(state)
        return _np(state)

    def unpack(self, packed):
        if hasattr(self.model, "shard_spectral"):
            return self.model.shard_spectral(packed)
        return jnp.asarray(packed)


class _ShallowWaterAdapter:
    kind = "shallow-water"

    def __init__(self, cfg, model=None):
        from .models.shallow_water import ShallowWaterModel
        self.cfg = cfg
        self.model = model or ShallowWaterModel.build(cfg)

    def init_from_physical(self, vort0):
        # balanced start eliminates the spurious gravity-wave burst a
        # vorticity-only IC would trigger (models/shallow_water.py)
        return self.model.geostrophic_init(vort0)

    def step(self, state, src):
        return self.model.step(state, src)

    def segment(self, state, src, n):
        return self.model.segment(state, src, n)

    def record_fields(self, state, only=None):
        d = self.model.diags(state)
        return _gather_fields(dict(vort=d.vort, psi=d.psi, u=d.u, v=d.v,
                                   div=d.div, h=d.h), only)

    def debug_record_fields(self, state, src):
        """--debug-fields dumps (main.cpp OUTPUT_GRAD_VORT/OUTPUT_DVORTDT)."""
        if getattr(self.model, "debug", None) is None:
            raise ValueError(
                "--debug-fields is not supported by this model build "
                f"({type(self.model).__name__} has no debug diagnostics)")
        d = self.model.debug(state, src)
        return dict(dvortdx=_np(d.dvortdx), dvortdy=_np(d.dvortdy),
                    dvortdt=_np(d.dvortdt))

    def stats(self, state):
        if not hasattr(self.model, "stats"):   # sharded models: skip
            return {}
        s = self.model.stats(state)
        return dict(mass=float(s.mass), energy=float(s.energy),
                    pot_enstrophy=float(s.pot_enstrophy),
                    max_abs_div=float(s.max_abs_div), cfl=float(s.cfl))

    def pack(self, state):
        if hasattr(self.model, "unshard_state"):
            return np.stack(list(self.model.unshard_state(state)))
        return np.stack([_np(a) for a in state])

    def unpack(self, packed):
        from .models.shallow_water import SWState
        st = SWState(*(jnp.asarray(a) for a in packed))
        if hasattr(self.model, "shard_state"):
            return self.model.shard_state(st)
        return st


class _TracerAdapter:
    """Passive-tracer family (models/tracer.py): barotropic dynamics plus
    a co-advected scalar q with its own diffusivity — records q_step_N.bin
    alongside the reference field set, feeding the Nakamura
    effective-diffusivity diagnostic with a real tracer."""

    kind = "tracer"

    def __init__(self, cfg, model=None, kappa=0.0, ic="vorticity"):
        from .models.tracer import TracerModel
        self.cfg = cfg
        self.ic = ic
        self.model = model or TracerModel.build(cfg, kappa=kappa)

    def init_from_physical(self, vort0):
        from .models.tracer import tracer_ic
        q0 = tracer_ic(self.cfg, self.ic, vort0)
        return self.model.init_state(vort0, q0)

    def step(self, state, src):
        return self.model.step(state, src)

    def segment(self, state, src, n):
        return self.model.segment(state, src, n)

    def record_fields(self, state, only=None):
        d = self.model.diags(state)
        return _gather_fields(dict(vort=d.vort, psi=d.psi,
                                   u=d.u, v=d.v, q=d.q), only)

    def stats(self, state):
        if not hasattr(self.model, "stats"):   # sharded models: skip
            return {}
        s = self.model.stats(state)
        return dict(max_abs_vort=float(s.max_abs_vort),
                    energy=float(s.energy),
                    enstrophy=float(s.enstrophy), cfl=float(s.cfl),
                    q_mean=float(s.q_mean), q_var=float(s.q_var))

    def pack(self, state):
        if hasattr(self.model, "unshard_state"):
            return np.stack(list(self.model.unshard_state(state)))
        return np.stack([_np(a) for a in state])

    def unpack(self, packed):
        from .models.tracer import TracerState
        st = TracerState(jnp.asarray(packed[0]), jnp.asarray(packed[1]))
        if hasattr(self.model, "shard_state"):
            return self.model.shard_state(st)
        return st


class _EnsembleAdapter:
    """vmap-batched M-member ensemble (models/ensemble.py) — a new
    capability with no reference counterpart. Each member's fields record
    into a per-member subdirectory (output/m00/vort_step_N.bin, ...) so
    every member tree keeps the exact reference output contract; forcing
    is shared across members (one stream, SURVEY.md §3.2)."""

    def __init__(self, cfg, model_kind: str, n_members: int,
                 amplitude: float = 0.05, seed: int = 0,
                 tracer_kappa: float = 0.0, vmap_width=None):
        from .models.ensemble import EnsembleModel
        self.cfg = cfg
        self.amplitude = amplitude
        self.seed = seed
        self.model = EnsembleModel.build(cfg, n_members,
                                         model_kind=model_kind,
                                         tracer_kappa=tracer_kappa,
                                         vmap_width=vmap_width)
        self._w = max(2, len(str(n_members - 1)))
        self.kind = f"ensemble-{self.model.inner.__class__.__name__}"

    def _prefix(self, k: int) -> str:
        return f"m{k:0{self._w}d}"

    def init_from_physical(self, vort0):
        return self.model.init_from_physical(vort0,
                                             amplitude=self.amplitude,
                                             seed=self.seed)

    def step(self, state, src):
        return self.model.step(state, src)

    def segment(self, state, src, n):
        return self.model.segment(state, src, n)

    def record_fields(self, state, only=None):
        d = self.model.diags(state)
        batched = _gather_fields(d._asdict(), only)
        out = {}
        for k in range(self.model.n_members):
            for name in batched:
                out[f"{self._prefix(k)}/{name}"] = batched[name][k]
        return out

    def stats(self, state):
        s = self.model.stats(state)
        d = {}
        for name, arr in s._asdict().items():
            vals = np.asarray(arr, dtype=np.float64)
            d[f"{name}_mean"] = float(vals.mean())
            d[f"{name}_std"] = float(vals.std())
        d["spread"] = float(self.model.spread(state))
        return d

    def pack(self, state):
        leaves = jax.tree_util.tree_leaves(state)
        if len(leaves) == 1:
            return _np(leaves[0])
        return np.stack([_np(a) for a in leaves])

    def unpack(self, packed):
        packed = np.asarray(packed)
        inner = self.model.inner.__class__.__name__
        if inner == "BarotropicModel":
            return jnp.asarray(packed)
        if inner == "ShallowWaterModel":
            from .models.shallow_water import SWState
            return SWState(*(jnp.asarray(a) for a in packed))
        from .models.tracer import TracerState
        return TracerState(jnp.asarray(packed[0]), jnp.asarray(packed[1]))


class _FDAdapter:
    """Finite-difference cross-check core (models/fd_core.py): state is
    (physical zeta, carried psi)."""

    kind = "fd"

    def __init__(self, cfg, model=None):
        from .models.fd_core import FDBarotropicModel
        self.cfg = cfg
        self.model = model or FDBarotropicModel.build(cfg)

    def init_from_physical(self, vort0):
        z = jnp.asarray(vort0, jnp.float32)
        return (z, self.model.init_psi(z))

    def step(self, state, src):
        return self.model.step(state[0], state[1], src)

    def segment(self, state, src, n):
        return self.model.segment(state[0], state[1], src, n)

    def record_fields(self, state, only=None):
        from .models.fd_core import gradients, poisson_fft
        z, _ = state
        psi = poisson_fft(z, self.cfg.dx, self.cfg.dy)
        u, v = gradients(psi, self.cfg.dx, self.cfg.dy)
        return _gather_fields(dict(vort=z, psi=psi, u=u, v=v), only)

    def stats(self, state):
        z = _np(state[0])
        return dict(max_abs_vort=float(np.abs(z).max()),
                    enstrophy=float(0.5 * np.mean(z * z)))

    def pack(self, state):
        return np.stack([_np(a) for a in state])

    def unpack(self, packed):
        return (jnp.asarray(packed[0]), jnp.asarray(packed[1]))


def make_adapter(cfg: ModelConfig, model_kind: str = "barotropic",
                 model=None, shard: bool = False,
                 decomp: str = "slab",
                 mesh_shape=None, tracer_kappa: float = 0.0,
                 tracer_ic: str = "vorticity",
                 ensemble: int = 0, ensemble_amp: float = 0.05,
                 ensemble_seed: int = 0, ensemble_width=None):
    if ensemble and ensemble > 1:
        if shard:
            raise ValueError("--ensemble and --shard are mutually "
                             "exclusive (batch within a device, shard "
                             "across devices)")
        return _EnsembleAdapter(cfg, model_kind, ensemble,
                                amplitude=ensemble_amp,
                                seed=ensemble_seed,
                                tracer_kappa=tracer_kappa,
                                vmap_width=ensemble_width)
    if shard and model is None:
        from .parallel import (ShardedBarotropicModel,
                               ShardedShallowWaterModel, make_mesh)
        if decomp == "pencil":
            from .parallel import pencil
            if mesh_shape is None:
                # hosts on the inter-host px axis, devices on py
                n_proc = jax.process_count()
                mesh_shape = (n_proc, len(jax.devices()) // n_proc)
            mesh = pencil.make_pencil_mesh(tuple(mesh_shape))
        else:
            mesh = make_mesh()
        if model_kind in ("barotropic", "bt"):
            model = ShardedBarotropicModel.build(cfg, mesh,
                                                 decomp=decomp)
        elif model_kind in ("shallow-water", "sw"):
            model = ShardedShallowWaterModel.build(cfg, mesh,
                                                   decomp=decomp)
        elif model_kind == "tracer":
            from .parallel import ShardedTracerModel
            model = ShardedTracerModel.build(cfg, mesh,
                                             decomp=decomp,
                                             kappa=tracer_kappa)
        else:
            raise ValueError(
                f"--shard is not supported for model kind {model_kind!r}")
    if model_kind in ("barotropic", "bt"):
        return _BarotropicAdapter(cfg, model)
    if model_kind in ("shallow-water", "sw"):
        return _ShallowWaterAdapter(cfg, model)
    if model_kind in ("fd", "jacobian"):
        return _FDAdapter(cfg, model)
    if model_kind == "tracer":
        return _TracerAdapter(cfg, model, kappa=tracer_kappa,
                              ic=tracer_ic)
    raise ValueError(f"unknown model kind {model_kind!r}")


def run(cfg: ModelConfig,
        vort0: Optional[np.ndarray] = None,
        recipe: str = "empty",
        src_path=None,
        record: bool = True,
        manifest_path: str = "log",
        progress: bool = False,
        resume_from=None,
        model: Optional[BarotropicModel] = None,
        model_kind: str = "barotropic",
        shard: bool = False,
        decomp: str = "slab",
        mesh_shape=None,
        collect_stats: bool = True,
        check_finite: bool = True,
        debug_fields: bool = False,
        tracer_kappa: float = 0.0,
        tracer_ic: str = "vorticity",
        ensemble: int = 0,
        ensemble_amp: float = 0.05,
        ensemble_seed: int = 0,
        ensemble_width=None,
        step_banners: bool = False,
        record_only=None) -> RunResult:
    """Integrate cfg.total_steps of the chosen model family.

    vort0: physical initial vorticity; if None, read from
    cfg.input_dir/cfg.init_file exactly like main.cpp:143-144.
    model_kind: 'barotropic' (default) or 'shallow-water' — the SW family
    starts from geostrophically balanced height/zero divergence.
    debug_fields: also dump dvortdx/dvortdy/dvortdt at record steps — the
    reference's OUTPUT_GRAD_VORT / OUTPUT_DVORTDT debug-output-as-test
    mechanism (main.cpp:156-176, 216-235), off by default like its #ifdefs.
    record_only: iterable of field names to record (None = the model's
    full set); unknown names raise. 'vort_src' gates the forcing dump.

    Multi-process discipline: field gathers (adapter.record_fields/pack via
    multihost.gather_to_host) are collectives run on EVERY process; the file
    writes — records, manifest, checkpoints — happen only on the primary
    rank (multihost.is_primary). Per-step banner note: the reference prints
    "# Step %d" EVERY step (main.cpp:262-264); here steps between record
    points run inside one jitted scan with no host round-trip, so by
    default the banner appears at record boundaries only.
    step_banners=True restores full reference stdout parity: the
    intermediate steps' banners are emitted when their segment completes
    (same lines, same order, printed in a burst per segment).
    """
    adapter = make_adapter(cfg, model_kind, model, shard=shard,
                           decomp=decomp,
                           mesh_shape=mesh_shape, tracer_kappa=tracer_kappa,
                           tracer_ic=tracer_ic, ensemble=ensemble,
                           ensemble_amp=ensemble_amp,
                           ensemble_seed=ensemble_seed,
                           ensemble_width=ensemble_width)
    if debug_fields and not hasattr(adapter, "debug_record_fields"):
        raise ValueError(
            f"--debug-fields is not supported for model kind {model_kind!r}")

    start_step = 0
    if resume_from is not None:
        state_np, start_step, _ = load_checkpoint(resume_from, cfg,
                                                  kind=adapter.kind)
        state = adapter.unpack(state_np)
    else:
        if vort0 is None:
            vort0 = read_field(Path(cfg.input_dir) / cfg.init_file,
                               cfg.grid_shape)
        state = adapter.init_from_physical(vort0)

    src_np = np.zeros(cfg.grid_shape, dtype=np.float32)
    src = jnp.asarray(src_np)
    reader: SourceReader = make_reader(cfg, recipe, src_path)

    # Host-side file I/O belongs to rank 0 alone (ADVICE r1: multi-process
    # runs must not race on the same record/manifest/checkpoint paths). The
    # GATHERS still run on every process — they are collectives.
    primary = is_primary()
    manifest = Manifest(manifest_path) if (record and primary) else None
    recorder = (FieldRecorder(cfg.output_dir, manifest)
                if (record and primary) else None)

    stats_history = []
    t0 = _time.perf_counter()
    step = start_step

    def do_record(step, state, src_np, src):
        fields = adapter.record_fields(state, only=record_only)  # gather
        if check_finite:
            from .utils.guards import check_finite as _cf
            _cf(step, **fields)
        dbg = (adapter.debug_record_fields(state, src)
               if debug_fields else {})            # collective gather
        if recorder is not None:
            want_src = record_only is None or "vort_src" in record_only
            recorder.record(step, vort_src=src_np if want_src else None,
                            **fields)
            if dbg:
                recorder.record(step, **dbg)

    etd = cfg.time_scheme == "etdrk4"

    def note_stats(step, state):
        if collect_stats:
            st = adapter.stats(state)
            stats_history.append(dict(step=step, **st))
            if etd and "cfl" in st:
                # the big-dt scheme's remaining stability limit: warn
                # at the initial record, abort with a clear error at
                # the first violating later record instead of a late
                # NaN BlowUpError (utils/guards.py:check_etd_cfl)
                from .utils.guards import check_etd_cfl
                check_etd_cfl(step, st["cfl"], cfg,
                              at_start=(step == start_step))

    per_step = recipe == "fifo"
    try:
        while step < cfg.total_steps:
            if record and step % cfg.record_step == 0:
                do_record(step, state, src_np, src)
                note_stats(step, state)
                if (progress or step_banners) and primary:
                    print(f"# Step {step}, time = {step * cfg.dt:.2f}, "
                          f"record now!", file=sys.stderr)
            elif step_banners and primary:
                print(f"# Step {step}, time = {step * cfg.dt:.2f}",
                      file=sys.stderr)
            if cfg.checkpoint_step and step % cfg.checkpoint_step == 0 and \
                    step > start_step:
                packed = adapter.pack(state)       # collective gather
                if primary:
                    save_checkpoint(
                        Path(cfg.output_dir) / f"ckpt_step_{step}.npz",
                        cfg, packed, step, kind=adapter.kind)

            if per_step:
                # main-shallow-water.cpp:304 — source read precedes the
                # step.
                changed, field = reader.read(step * cfg.dt)
                if changed:
                    src_np = np.asarray(field, dtype=np.float32)
                    src = jnp.asarray(src_np)
                state = adapter.step(state, src)
                step += 1
            else:
                # run to the next record/checkpoint/recipe boundary in one
                # scan
                boundaries = [
                    cfg.total_steps,
                    ((step // cfg.record_step) + 1) * cfg.record_step]
                if cfg.checkpoint_step:
                    boundaries.append(
                        ((step // cfg.checkpoint_step) + 1)
                        * cfg.checkpoint_step)
                if recipe == "script":
                    changed, field = reader.read(step * cfg.dt)
                    if changed:
                        src_np = np.asarray(field, dtype=np.float32)
                        src = jnp.asarray(src_np)
                    nxt = _next_recipe_step(reader, cfg, step)
                    if nxt is not None:
                        boundaries.append(nxt)
                n = max(1, min(boundaries) - step)
                state = adapter.segment(state, src, n)
                if step_banners and primary:
                    # the scanned steps never reach the loop head; emit
                    # their reference-format banners now (main.cpp:262-264)
                    for k in range(step + 1, step + n):
                        print(f"# Step {k}, time = {k * cfg.dt:.2f}",
                              file=sys.stderr)
                step += n

        jax.block_until_ready(state)
    finally:
        # BlowUpError (and any mid-run failure) must not leak the native
        # FIFO prefetch thread/pipe fd or leave the manifest unflushed
        # (ADVICE r1).
        if manifest is not None:
            manifest.close()
        reader.close()
    wall = _time.perf_counter() - t0
    return RunResult(zeta_hat=state, steps_run=step - start_step,
                     wall_time=wall, stats_history=stats_history)


def _next_recipe_step(reader, cfg, step):
    """First future step at which a SCRIPT recipe fires, or None."""
    if not hasattr(reader, "recipes") or reader._next >= len(reader.recipes):
        return None
    t_next = reader.recipes[reader._next][0]
    import math
    return max(step + 1, int(math.ceil(t_next / cfg.dt)))
