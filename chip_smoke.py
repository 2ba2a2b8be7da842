"""Smoke test of the solver on an NVIDIA GPU: the quickest proof that the
system starts, runs its main path, and agrees with its references there.

    python chip_smoke.py           # one GPU, one process (about 10 min cold)
    python chip_smoke.py --four    # the sharded path on four GPUs only

Phases of the one-GPU run (any failure raises and exits non-zero):

1. device: the card's name and power limit from nvidia-smi (a child
   process that does not import JAX), then JAX's platform, device kind and
   device count. A platform other than "gpu" is a failure; there is no
   CPU fallback.
2. reference deployment through the CLIs, as in README.md's end-to-end
   example at the reference's own settings (768^2, dt 3 s, a record every
   100 steps, 1200 steps): makefield kuo2004, vort_src_input feeding a FIFO
   into `cli.run -f`, invert_pres, find_min. The producer is a separate
   process that must never open the card (checked through /proc); the
   JAX-side CLIs run in this process through their `main` entry points,
   so one process holds the card. Records, the `log` manifest and the
   pressure-minima file must exist and be finite.
3. each family at 4096^2 through its `build()`: barotropic, shallow water
   at max_stable_dt, tracer, barotropic ETDRK4 (and SW-ETDRK4 at 2048^2,
   whose host table build takes minutes at 4096^2): step compile seconds,
   ms/step of a timed 20-step segment, the step's memory_analysis() and
   the device's peak_bytes_in_use.
4. agreement with the plain references: barotropic at 768^2 after 20 steps
   against the numpy float32 oracle (oracle/reference_cpu.py); SW, tracer,
   barotropic ETDRK4 and SW-ETDRK4 at 512^2 after 20 steps against the same
   model on the CPU device of this process. Relative L2 <= 1e-5 (the CPU
   contract is < 1e-6; cuFFT sums in another order, so one decade is
   allowed; SW eta, which integrates -H*div, is held to 5e-5, see
   ETA_TOL). A failing comparison is rerun under
   jax.default_matmul_precision("highest") to rule TF32 out, and both
   numbers are printed; the phase still fails.
5. the transform choice: barotropic at 4096^2 with fft_backend 'xla'
   (cuFFT) against 'mxu' (ops/mxu_fft.py, the DFT-as-matmul form).

--four runs only the sharded path (ShardedBarotropicModel,
ShardedShallowWaterModel, ShardedTracerModel on slab, xpencil and a 2x2
pencil mesh at 4096^2 for 10 steps, each against the single-device model
on device 0, plus one `xfb-run --shard --decomp xpencil` run with records).

The last line of standard output is the JSON result
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}};
it is printed only when every phase passed. The measured numbers also go
to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import NamedTuple

REPO = Path(__file__).resolve().parent
TOL = 1e-5            # relative L2 on the card (CPU contract 1e-6)
# SW eta (the depth perturbation) integrates -H*div: H*dt ~ 1e4 amplifies
# div-level transform round-off into eta at the 1e-5 class (1.56e-5 at
# 512^2 and max_stable_dt on an H100 80GB HBM3 at 700 W, the same under
# HIGHEST matmul precision). The multi-device gate
# (__graft_entry__.dryrun_multichip) holds SW-ETDRK4 eta to 5e-5 on CPU
# meshes for the same reason.
ETA_TOL = 5e-5


def tolerance(field: str) -> float:
    return ETA_TOL if field == "eta" else TOL


SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


class SmokeFailure(RuntimeError):
    """A phase's check did not hold."""


class Sizes(NamedTuple):
    """Grid sizes and step counts of the run; the defaults are the real
    ones, and the CPU rehearsal passes small ones."""
    pipeline_n: int = 768        # reference deployment (configuration.hpp)
    pipeline_steps: int = 1200
    family_n: int = 4096
    sw_etd_n: int = 2048
    steps: int = 20
    oracle_n: int = 768
    compare_n: int = 512
    four_n: int = 4096
    four_steps: int = 10


# --------------------------------------------------------------------------
# device and result line
# --------------------------------------------------------------------------

def query_smi() -> str:
    """nvidia-smi's name/power-limit lines, from a child process that does
    not import JAX. A machine without the tool or a card fails here."""
    try:
        out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                             timeout=60)
    except FileNotFoundError as e:
        raise SmokeFailure(f"nvidia-smi not found: no GPU here ({e})")
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed (rc {out.returncode}): "
                           f"{out.stderr.strip()}")
    return out.stdout.strip()


def parse_smi(line: str) -> dict:
    """'NVIDIA H100 80GB HBM3, 700.00 W' -> {'name': ..., 'power_limit':
    ...}; the name itself may hold commas, the limit never does."""
    name, sep, limit = line.strip().rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise SmokeFailure(f"unexpected nvidia-smi line {line!r}")
    return {"name": name.strip(), "power_limit": limit.strip()}


def require_gpu(devices) -> None:
    """Refuse any platform but the GPU: numbers from another device would
    be read as the card's."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SmokeFailure(f"JAX platform is {plat!r}, not 'gpu'")


def device_info(devices) -> dict:
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def result_line(devices) -> str:
    """The final stdout line the caller reads."""
    return json.dumps({"ok": True, "device": device_info(devices)})


def rel_l2(a, b, norm=None) -> float:
    import numpy as np
    a = np.asarray(a)
    b = np.asarray(b)
    n = np.linalg.norm(np.ravel(b if norm is None else norm))
    return float(np.linalg.norm(np.ravel(a - b)) / max(n, 1e-30))


def _check_finite(label: str, arr) -> None:
    import numpy as np
    if not np.all(np.isfinite(np.asarray(arr))):
        raise SmokeFailure(f"{label}: non-finite values")


def _say(*a) -> None:
    print(*a, flush=True)


# --------------------------------------------------------------------------
# phase 4: comparisons (each takes the device to run on; the CPU works too)
# --------------------------------------------------------------------------

FAMILIES = ("sw", "tracer", "bt-etdrk4", "sw-etdrk4")


def _family_setup(family: str, n: int):
    """(config, build(cfg) -> model, init(model) -> state, field names)
    for one family at n^2, with a dt inside its stability bound."""
    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields
    cfg = ModelConfig(nx=n, ny=n)
    if family in ("sw", "sw-etdrk4"):
        from xlab_fftbarotropic.models.shallow_water import (
            ShallowWaterModel, max_stable_dt)
        bound = max_stable_dt(cfg)
        # ETDRK4 at twice the RK4 gravity-wave bound: beyond what RK4
        # can run, and close enough that the card-vs-CPU comparison is
        # not dominated by the adjustment transient's amplification of
        # round-off
        cfg = (cfg.replace(dt=bound) if family == "sw" else
               cfg.replace(dt=2.0 * bound, time_scheme="etdrk4"))
        return (cfg, ShallowWaterModel.build,
                lambda m: m.geostrophic_init(
                    makefields.gaussian(m.cfg, zeta0=1e-5)),
                ("zeta", "div", "eta"))
    if family == "tracer":
        from xlab_fftbarotropic.models.tracer import (TracerModel,
                                                          tracer_ic)
        return (cfg, lambda c: TracerModel.build(c, kappa=50.0),
                lambda m: m.init_state(makefields.gaussian(m.cfg),
                                       tracer_ic(m.cfg, "gaussian")),
                ("zeta", "q"))
    if family in ("barotropic", "bt-etdrk4"):
        from xlab_fftbarotropic.models.barotropic import BarotropicModel
        if family == "bt-etdrk4":
            cfg = cfg.replace(time_scheme="etdrk4")
        return (cfg, BarotropicModel.build,
                lambda m: m.init_state(makefields.gaussian(m.cfg)),
                ("zeta",))
    raise ValueError(f"unknown family {family!r}")


def _source(model):
    # the SW family takes src=None as "unforced" (no source transform)
    return None if type(model).__name__ == "ShallowWaterModel" \
        else model.zero_source()


def _run_family(family: str, device, n: int, steps: int):
    import jax
    import numpy as np
    cfg, build, init, _ = _family_setup(family, n)
    with jax.default_device(device):
        m = build(cfg)
        out = m.segment(init(m), _source(m), steps)
        leaves = out if isinstance(out, tuple) else (out,)
        return [np.asarray(a) for a in leaves]


def compare_family(family: str, device, n: int = 512,
                   steps: int = 20) -> dict:
    """The same jitted model on `device` and on the CPU device: relative
    L2 per prognostic field. SW div, the small residual of cancelling
    zeta-scale terms, is normalised by zeta's norm; eta is the depth
    PERTURBATION and is compared against its own norm (the
    tests/test_shallow_water.py policy)."""
    import jax
    names = _family_setup(family, n)[3]
    got = _run_family(family, device, n, steps)
    want = _run_family(family, jax.devices("cpu")[0], n, steps)
    errs = {}
    for i, name in enumerate(names):
        _check_finite(f"{family} {name}", got[i])
        norm = want[0] if name == "div" else None
        errs[name] = rel_l2(got[i], want[i], norm=norm)
    return errs


def compare_oracle(device, n: int = 768, steps: int = 20) -> float:
    """Barotropic on `device` against the numpy float32 oracle after
    `steps` steps from the Kuo2004 IC: relative L2 of vorticity."""
    import jax
    import numpy as np
    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.models.barotropic import BarotropicModel
    from xlab_fftbarotropic.oracle.reference_cpu import OracleBarotropic

    cfg = ModelConfig(nx=n, ny=n)
    vort0 = makefields.kuo2004(cfg)
    with jax.default_device(device):
        m = BarotropicModel.build(cfg)
        z = m.segment(m.init_state(vort0), m.zero_source(), steps)
        got = np.asarray(m.diags(z).vort)
    _check_finite("oracle comparison", got)
    want = OracleBarotropic(cfg).run(vort0, steps)
    return rel_l2(got, want)


def _failed(errs: dict) -> list:
    return [k for k, v in errs.items() if not v <= tolerance(k)]


def _compare_with_precision_check(label: str, fn) -> dict:
    """Run a comparison ({field: rel L2}) and print it with each field's
    tolerance. A failing one is rerun under HIGHEST matmul precision
    (rules TF32 out) and both numbers are printed and returned; the
    caller fails on either."""
    import jax
    errs = fn()
    tols = {k: tolerance(k) for k in errs}
    _say(f"[phase 4] {label}: rel L2 {errs} (tolerance {tols})")
    out = {"rel_l2": errs, "tolerance": tols, "failed": _failed(errs)}
    if out["failed"]:
        with jax.default_matmul_precision("highest"):
            out["rel_l2_highest"] = fn()
        _say(f"[phase 4] {label} under matmul precision 'highest': "
             f"{out['rel_l2_highest']}")
    return out


# --------------------------------------------------------------------------
# timing helpers
# --------------------------------------------------------------------------

def _memory_analysis(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {k: int(getattr(ma, k)) for k in dir(ma)
            if k.endswith("_in_bytes") and getattr(ma, k)}


def _peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def measure_family(family: str, n: int, steps: int = 20) -> dict:
    """Build at n^2, AOT-compile the step (compile seconds and its
    memory_analysis), then a warm-up and a timed `steps`-step segment."""
    import jax
    cfg, build, init, names = _family_setup(family, n)
    t0 = time.perf_counter()
    m = build(cfg)
    build_s = time.perf_counter() - t0
    state = init(m)
    src = _source(m)
    step = m.step            # functools.partial(jitted, tables...)
    t0 = time.perf_counter()
    compiled = step.func.lower(*step.args, state, src).compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(m.segment(state, src, steps))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(m.segment(state, src, steps))
    run_s = time.perf_counter() - t0
    leaves = out if isinstance(out, tuple) else (out,)
    for name, a in zip(names, leaves):
        _check_finite(f"{family} {n}^2 {name}", a)
    return {"n": n, "dt": float(cfg.dt), "build_s": round(build_s, 3),
            "step_compile_s": round(compile_s, 3),
            "segment_first_call_s": round(first_s, 3),
            "ms_per_step": run_s / steps * 1e3,
            "step_memory_analysis": _memory_analysis(compiled),
            "peak_bytes_in_use": _peak_bytes(jax.devices()[0])}


def _time_segment(model, state, src, steps: int):
    import jax
    jax.block_until_ready(model.segment(state, src, steps))
    t0 = time.perf_counter()
    out = jax.block_until_ready(model.segment(state, src, steps))
    return out, (time.perf_counter() - t0) / steps * 1e3


# --------------------------------------------------------------------------
# phase 2: the README pipeline
# --------------------------------------------------------------------------

class _CardWatch(threading.Thread):
    """Polls /proc/<pid> of a child while it lives: does it map the CUDA
    driver or hold a /dev/nvidia* file open?"""

    def __init__(self, pid: int):
        super().__init__(daemon=True)
        self.pid = pid
        self.samples = 0
        self.hits = []
        self.done = threading.Event()

    def run(self):
        proc = Path(f"/proc/{self.pid}")
        while not self.done.is_set():
            try:
                maps = (proc / "maps").read_text()
                fds = [os.readlink(p) for p in (proc / "fd").iterdir()]
            except (FileNotFoundError, ProcessLookupError):
                return               # the child has exited
            self.samples += 1
            if "libcuda" in maps:
                self.hits.append("maps libcuda")
            self.hits += [f for f in fds if f.startswith("/dev/nvidia")]
            self.done.wait(0.2)


@contextlib.contextmanager
def _cwd(path: Path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def reference_pipeline(n: int = 768, steps: int = 1200,
                       work: Path = REPO / "output" / "chip_smoke_pipeline"
                       ) -> dict:
    from xlab_fftbarotropic.cli import find_min as cli_find_min
    from xlab_fftbarotropic.cli import invert_pres as cli_invert
    from xlab_fftbarotropic.cli import makefield as cli_makefield
    from xlab_fftbarotropic.cli import run as cli_run
    from xlab_fftbarotropic.io.fieldio import read_field

    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    grid = ["--nx", str(n), "--ny", str(n)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    with _cwd(work):
        cli_makefield.main(["kuo2004", "-I", "input"] + grid)
        os.mkfifo("vort_src_fifo")
        args = grid + ["--total-steps", str(steps)]
        producer = subprocess.Popen(
            ["sh", "-c", f"exec '{sys.executable}' -m "
             "xlab_fftbarotropic.cli.vort_src_input "
             f"{' '.join(args)} > vort_src_fifo"], env=env)
        watch = _CardWatch(producer.pid)
        watch.start()
        try:
            t0 = time.perf_counter()
            cli_run.main(["-I", "input", "-O", "output",
                          "-f", "vort_src_fifo"] + args)
            run_s = time.perf_counter() - t0
            rc = producer.wait(timeout=120)
        finally:
            watch.done.set()
            if producer.poll() is None:     # run failed: stop the producer
                producer.kill()
                producer.wait()
        watch.join(timeout=10)
        if rc != 0:
            raise SmokeFailure(f"vort_src_input exited {rc}")
        if watch.samples == 0 or watch.hits:
            raise SmokeFailure(f"producer card check: {watch.samples} "
                               f"samples, card use {watch.hits}")

        log = Path("log").read_text().split()
        psi = [p for p in log if "psi_step" in p]
        pairs = "\n".join(f"{p}=>{p.replace('psi', 'pres', 1)}"
                          for p in psi) + "\n"
        with _stdin(io.StringIO(pairs)):
            cli_invert.main(grid)
        pres = sorted((p for p in os.listdir("output")
                       if p.startswith("pres_step")),
                      key=lambda p: int(p.split("_")[2].split(".")[0]))
        names = "".join(f"output/{p}\n" for p in pres)
        with _stdin(io.StringIO(names)), \
                open("output/pres_timeseries.txt", "w") as f, \
                contextlib.redirect_stdout(f):
            cli_find_min.main(grid)

        n_rec = -(-steps // 100)
        expect = [f"output/{k}_step_{s}.bin"
                  for s in range(0, steps, 100)
                  for k in ("vort_src_input", "vort", "psi", "u", "v")]
        missing = sorted(set(expect) - set(log))
        if missing:
            raise SmokeFailure(f"log lacks {missing[:4]} ...")
        for p in expect:
            _check_finite(p, read_field(p, (n, n)))
        if len(pres) != n_rec:
            raise SmokeFailure(f"{len(pres)} pressure files, want {n_rec}")
        for p in pres:
            _check_finite(p, read_field(f"output/{p}", (n, n)))
        rows = Path("output/pres_timeseries.txt").read_text().split("\n")
        vals = [float(r.split()[2]) for r in rows if r.strip()]
        if len(vals) != 30 * n_rec:
            raise SmokeFailure(f"{len(vals)} minima, want {30 * n_rec}")
        _check_finite("pres_timeseries", vals)
    return {"n": n, "steps": steps, "records": n_rec,
            "cli_run_wall_s": round(run_s, 3),
            "producer_card_samples": watch.samples,
            "deepest_pressure_minimum": min(vals)}


@contextlib.contextmanager
def _stdin(stream):
    old = sys.stdin
    sys.stdin = stream
    try:
        yield
    finally:
        sys.stdin = old


# --------------------------------------------------------------------------
# the one-GPU run
# --------------------------------------------------------------------------

def run_single(results: dict, sz: Sizes = Sizes()) -> None:
    import jax
    import numpy as np
    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.models.barotropic import BarotropicModel

    dev = jax.devices()[0]
    t0 = time.perf_counter()
    results["pipeline"] = reference_pipeline(sz.pipeline_n,
                                             sz.pipeline_steps)
    _say(f"[phase 2] reference pipeline: {results['pipeline']} "
         f"({time.perf_counter() - t0:.1f} s)")

    fam = {}
    for family, n in (("barotropic", sz.family_n), ("sw", sz.family_n),
                      ("tracer", sz.family_n), ("bt-etdrk4", sz.family_n),
                      ("sw-etdrk4", sz.sw_etd_n)):
        fam[family] = measure_family(family, n, sz.steps)
        _say(f"[phase 3] {family} {n}^2: {fam[family]}")
    results["families"] = fam

    cmp = {"barotropic_vs_oracle": _compare_with_precision_check(
        f"barotropic {sz.oracle_n}^2 vs numpy oracle",
        lambda: {"zeta": compare_oracle(dev, sz.oracle_n, sz.steps)})}
    for family in FAMILIES:
        cmp[f"{family}_vs_cpu"] = _compare_with_precision_check(
            f"{family} {sz.compare_n}^2 vs CPU",
            lambda f=family: compare_family(f, dev, sz.compare_n, sz.steps))
    results["comparisons"] = cmp
    bad = {k: v["failed"] for k, v in cmp.items() if v["failed"]}
    if bad:
        raise SmokeFailure(f"phase 4 comparisons over tolerance: {bad}")

    n = sz.family_n
    cfg = ModelConfig(nx=n, ny=n)
    vort0 = makefields.gaussian(cfg)
    outs, ms = {}, {}
    for backend in ("xla", "mxu"):
        m = BarotropicModel.build(cfg.replace(fft_backend=backend))
        z = m.init_state(vort0)
        out, ms[backend] = _time_segment(m, z, m.zero_source(), sz.steps)
        outs[backend] = np.asarray(out)
        _check_finite(f"{backend} {n}^2", outs[backend])
        del m, z, out
    agree = rel_l2(outs["mxu"], outs["xla"])
    results["transforms"] = {"n": n, "xla_ms_per_step": ms["xla"],
                             "mxu_ms_per_step": ms["mxu"],
                             "mxu_vs_xla_rel_l2": agree}
    _say(f"[phase 5] {n}^2 barotropic: xla (cuFFT) {ms['xla']:.3f} "
         f"ms/step, mxu (DFT matmul) {ms['mxu']:.3f} ms/step, "
         f"rel L2 {agree:.2e}")
    if agree > TOL:
        raise SmokeFailure(f"mxu and xla disagree: rel L2 {agree:.2e}")


# --------------------------------------------------------------------------
# the four-GPU run
# --------------------------------------------------------------------------

def _on_all(arr, devices) -> None:
    import jax
    got = {s.device for leaf in jax.tree_util.tree_leaves(arr)
           for s in leaf.addressable_shards}
    if got != set(devices):
        raise SmokeFailure(f"shards on {sorted(map(str, got))}, want all "
                           f"{len(devices)} devices")


def run_four(results: dict, sz: Sizes = Sizes()) -> None:
    import jax
    import numpy as np
    from xlab_fftbarotropic.cli import run as cli_run
    from xlab_fftbarotropic.io.fieldio import read_field, write_field
    from xlab_fftbarotropic.parallel import (
        ShardedBarotropicModel, ShardedShallowWaterModel,
        ShardedTracerModel, make_mesh, pencil)

    devs = jax.devices()
    if len(devs) != 4:
        raise SmokeFailure(f"--four needs 4 GPUs, JAX sees {len(devs)}")
    n, steps = sz.four_n, sz.four_steps
    meshes = {"slab": make_mesh(devs), "xpencil": make_mesh(devs),
              "pencil": pencil.make_pencil_mesh((2, 2), devs)}
    sharded = {"barotropic": ShardedBarotropicModel.build,
               "sw": ShardedShallowWaterModel.build,
               "tracer": lambda c, mesh, decomp: ShardedTracerModel.build(
                   c, mesh, decomp=decomp, kappa=50.0)}
    out = {}
    for family in ("barotropic", "sw", "tracer"):
        cfg, build, init, names = _family_setup(family, n)
        with jax.default_device(devs[0]):
            single = build(cfg)
            s0 = init(single)
            ref, ms1 = _time_segment(single, s0, _source(single), steps)
            ref = [np.asarray(a) for a in
                   (ref if isinstance(ref, tuple) else (ref,))]
            del single
        out[f"{family} single"] = {"ms_per_step": ms1}
        _say(f"[four] {family} single device: {ms1:.3f} ms/step")
        for decomp, mesh in meshes.items():
            m = sharded[family](cfg, mesh, decomp=decomp)
            if family == "barotropic":
                state = m.shard_spectral(np.asarray(s0))
                got, ms = _time_segment(m, state, m.zero_source(), steps)
                _on_all(got, devs)
                got = [m.unshard_spectral(got)]
            else:
                state = m.shard_state(s0)
                got, ms = _time_segment(m, state, m.zero_source(), steps)
                _on_all(got, devs)
                got = list(m.unshard_state(got))
            errs = {}
            for i, name in enumerate(names):
                norm = ref[0] if name == "div" else None
                errs[name] = rel_l2(got[i], ref[i], norm=norm)
            out[f"{family} {decomp}"] = {"ms_per_step": ms,
                                         "rel_l2": errs}
            label = f"{family} {decomp}" + (" 2x2" if decomp == "pencil"
                                             else "")
            _say(f"[four] {label}: {ms:.3f} ms/step, rel L2 {errs}")
            if _failed(errs):
                raise SmokeFailure(f"{family} {decomp}: {errs} over "
                                   "tolerance")
            del m, state, got

    work = REPO / "output" / "chip_smoke_four"
    if work.exists():
        shutil.rmtree(work)
    (work / "input").mkdir(parents=True)
    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields
    cfg = ModelConfig(nx=n, ny=n)
    write_field(work / "input" / cfg.init_file, makefields.gaussian(cfg))
    with _cwd(work):
        t0 = time.perf_counter()
        cli_run.main(["-I", "input", "-O", "output", "--nx", str(n),
                      "--ny", str(n), "--total-steps", str(2 * steps),
                      "--record-step", str(steps),
                      "--record-fields", "vort,psi",
                      "--shard", "--decomp", "xpencil"])
        wall = time.perf_counter() - t0
        log = Path("log").read_text().split()
        for p in log:
            _check_finite(p, read_field(p, (n, n)))
        if len([p for p in log if "vort_step" in p]) != 2:
            raise SmokeFailure(f"xfb-run --shard records: {log}")
    out["xfb-run --shard --decomp xpencil"] = {"wall_s": round(wall, 3),
                                               "records": len(log)}
    _say(f"[four] xfb-run --shard --decomp xpencil {2 * steps} steps: "
         f"{wall:.1f} s "
         f"wall, {len(log)} record files finite")
    results["four"] = out


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    smi = query_smi()
    for line in smi.splitlines():
        card = parse_smi(line)
        _say(f"[phase 1] nvidia-smi: {card['name']}, power limit "
             f"{card['power_limit']}")

    # the CPU device joins the GPU for the phase-4 comparisons
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    from xlab_fftbarotropic.utils.compile_cache import (
        enable_compile_cache)
    cache = enable_compile_cache()
    import jax

    devices = jax.devices()
    info = device_info(devices)
    _say(f"[phase 1] JAX: platform {info['platform']}, device_kind "
         f"{info['kind']}, {info['count']} device(s); compile cache "
         f"{cache or os.environ.get('JAX_COMPILATION_CACHE_DIR')}")
    require_gpu(devices)

    results = {"nvidia_smi": smi, "device": info}
    t0 = time.perf_counter()
    if args.four:
        run_four(results)
    else:
        run_single(results)
    results["wall_s"] = round(time.perf_counter() - t0, 1)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = "chip_smoke_four.json" if args.four else "chip_smoke.json"
    (out / name).write_text(json.dumps(results, indent=1) + "\n")
    _say(f"[done] {results['wall_s']} s; numbers in chiprun_out/{name}")
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
