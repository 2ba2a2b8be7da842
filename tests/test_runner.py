"""End-to-end runner tests: record contract, manifest, forcing, resume.

These are the automated analogue of the reference's shell-driven example
pipelines (test/01-runtest/example.sh, test/02-test_invert_pressure/
example.sh) — the reference's only 'tests' (SURVEY.md §4).
"""

import os
import threading

import numpy as np
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.forcing import source as fsrc
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.io.fieldio import read_field, write_field
from xlab_fftbarotropic.runner import run


def make_cfg(tmp_path, **kw):
    base = dict(nx=32, ny=32, dt=3.0, record_step=5, total_steps=10,
                input_dir=str(tmp_path / "input"),
                output_dir=str(tmp_path / "output"))
    base.update(kw)
    return ModelConfig(**base)


class TestRunContract:
    def test_records_and_manifest(self, tmp_path):
        cfg = make_cfg(tmp_path)
        vort0 = makefields.gaussian(cfg)
        res = run(cfg, vort0, manifest_path=str(tmp_path / "log"))
        assert res.steps_run == 10
        out = tmp_path / "output"
        # record steps 0 and 5, each with the 5-file contract (SURVEY.md §5.9)
        for step in (0, 5):
            for name in ("vort_src_input", "vort", "psi", "u", "v"):
                assert (out / f"{name}_step_{step}.bin").exists(), (name, step)
        lines = (tmp_path / "log").read_text().splitlines()
        assert len(lines) == 10
        # recorded vorticity at step 0 equals roundtripped IC
        v0 = read_field(out / "vort_step_0.bin", cfg.grid_shape)
        np.testing.assert_allclose(v0, vort0, atol=2e-8)
        # stats were collected at record points
        assert [s["step"] for s in res.stats_history] == [0, 5]

    def test_init_from_file_like_reference(self, tmp_path):
        """vort0=None reads input_dir/init_file (main.cpp:143-144)."""
        cfg = make_cfg(tmp_path)
        os.makedirs(cfg.input_dir)
        vort0 = makefields.kuo2004(cfg)
        write_field(os.path.join(cfg.input_dir, cfg.init_file), vort0)
        res = run(cfg, manifest_path=str(tmp_path / "log"))
        assert res.steps_run == 10

    def test_norecord_run(self, tmp_path):
        cfg = make_cfg(tmp_path)
        res = run(cfg, makefields.gaussian(cfg), record=False)
        assert res.steps_run == 10
        assert not os.path.exists(cfg.output_dir)


class TestSegmentEquivalence:
    def test_segmented_equals_stepwise(self, tmp_path):
        """The scanned hot path must equal per-step stepping exactly
        (same jitted step function, same order of operations)."""
        from xlab_fftbarotropic.models.barotropic import BarotropicModel
        cfg = make_cfg(tmp_path, total_steps=8)
        vort0 = makefields.gaussian(cfg)
        model = BarotropicModel.build(cfg)
        z_seg = model.segment(model.init_state(vort0), model.zero_source(), 8)
        z_step = model.init_state(vort0)
        for _ in range(8):
            z_step = model.step(z_step, model.zero_source())
        np.testing.assert_allclose(np.asarray(z_seg), np.asarray(z_step),
                                   rtol=2e-4, atol=1e-6)


class TestForcedRuns:
    def test_fifo_run_pipeline(self, tmp_path):
        """Full producer->FIFO->model pipeline, the analogue of
        test/02-test_invert_pressure/example.sh:10-13."""
        cfg = make_cfg(tmp_path, total_steps=8, record_step=4)
        vort0 = makefields.gaussian(cfg)
        fifo = tmp_path / "vort_src_fifo"
        os.mkfifo(fifo)
        src_field = makefields.cake_kuo2004(
            cfg, cfg.lx / 2, cfg.ly / 2, 1e-6, 60_000.0)

        def producer():
            with open(fifo, "wb") as w:
                for step in range(cfg.total_steps):
                    fsrc.write_step(w, src_field if step == 2 else None)

        th = threading.Thread(target=producer)
        th.start()
        res = run(cfg, vort0, recipe="fifo", src_path=str(fifo),
                  manifest_path=str(tmp_path / "log"))
        th.join()
        assert res.steps_run == 8
        # source active from step 2 on -> recorded at step 4
        rec = read_field(tmp_path / "output" / "vort_src_input_step_4.bin",
                         cfg.grid_shape)
        np.testing.assert_array_equal(rec, src_field)

    def test_fifo_equals_constant_source_run(self, tmp_path):
        """FIFO delivering S at t=0 must reproduce a constant-source run."""
        cfg = make_cfg(tmp_path, total_steps=6)
        vort0 = makefields.gaussian(cfg)
        src_field = (0.1 * makefields.gaussian(cfg)).astype(np.float32)
        fifo = tmp_path / "fifo"
        os.mkfifo(fifo)

        def producer():
            with open(fifo, "wb") as w:
                fsrc.write_step(w, src_field)
                for _ in range(cfg.total_steps - 1):
                    fsrc.write_step(w, None)

        th = threading.Thread(target=producer)
        th.start()
        res_fifo = run(cfg, vort0, recipe="fifo", src_path=str(fifo),
                       record=False)
        th.join()

        from xlab_fftbarotropic.models.barotropic import BarotropicModel
        import jax.numpy as jnp
        model = BarotropicModel.build(cfg)
        z = model.segment(model.init_state(vort0), jnp.asarray(src_field), 6)
        np.testing.assert_allclose(np.asarray(res_fifo.zeta_hat),
                                   np.asarray(z), rtol=2e-4, atol=1e-6)

    def test_script_run(self, tmp_path):
        """SCRIPT forcing fires at its recipe time mid-run."""
        cfg = make_cfg(tmp_path, total_steps=10, record_step=5)
        vort0 = makefields.gaussian(cfg)
        src_field = (0.1 * makefields.gaussian(cfg)).astype(np.float32)
        write_field(tmp_path / "s.bin", src_field)
        script = tmp_path / "recipe.txt"
        # fires at t=9s -> step 3
        script.write_text(f"9.0 {tmp_path}/s.bin\n")
        res = run(cfg, vort0, recipe="script", src_path=str(script),
                  manifest_path=str(tmp_path / "log"))
        assert res.steps_run == 10
        rec = read_field(tmp_path / "output" / "vort_src_input_step_5.bin",
                         cfg.grid_shape)
        np.testing.assert_array_equal(rec, src_field)
        rec0 = read_field(tmp_path / "output" / "vort_src_input_step_0.bin",
                          cfg.grid_shape)
        assert np.all(rec0 == 0)


class TestResume:
    def test_checkpoint_resume_is_deterministic(self, tmp_path):
        cfg = make_cfg(tmp_path, total_steps=10, checkpoint_step=5,
                       record_step=100)
        vort0 = makefields.gaussian(cfg)
        res_full = run(cfg, vort0, record=False,
                       manifest_path=str(tmp_path / "log"))
        # the no-record run skips field output but checkpoints land in output_dir
        ck = os.path.join(cfg.output_dir, "ckpt_step_5.npz")
        assert os.path.exists(ck)
        res_resumed = run(cfg, record=False, resume_from=ck,
                          manifest_path=str(tmp_path / "log2"))
        assert res_resumed.steps_run == 5
        np.testing.assert_array_equal(np.asarray(res_full.zeta_hat),
                                      np.asarray(res_resumed.zeta_hat))


def test_runner_shallow_water_records_and_resumes(tmp_path):
    from xlab_fftbarotropic import runner
    from xlab_fftbarotropic.ic import makefields
    import numpy as np
    cfg = ModelConfig(nx=32, ny=32, total_steps=20, record_step=10,
                      checkpoint_step=10, output_dir=str(tmp_path / "out"))
    vort0 = makefields.gaussian(cfg, zeta0=1e-5)
    r = runner.run(cfg, vort0=vort0, model_kind="shallow-water",
                   manifest_path=str(tmp_path / "log"))
    assert r.steps_run == 20
    # SW-specific record fields present
    for name in ("vort", "psi", "u", "v", "div", "h"):
        assert (tmp_path / "out" / f"{name}_step_10.bin").exists(), name
    assert "mass" in r.stats_history[0]
    # resume from the checkpoint reproduces the final state
    r2 = runner.run(cfg, model_kind="shallow-water",
                    resume_from=tmp_path / "out" / "ckpt_step_10.npz",
                    manifest_path=str(tmp_path / "log2"), record=False)
    assert r2.steps_run == 10
    for a, b in zip(r.zeta_hat, r2.zeta_hat):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-8)


def test_resume_into_different_output_dir(tmp_path):
    """Path fields must not affect the restart hash (only numerics do)."""
    from xlab_fftbarotropic import runner
    from xlab_fftbarotropic.ic import makefields
    cfg = ModelConfig(nx=32, ny=32, total_steps=10, record_step=5,
                      checkpoint_step=5, output_dir=str(tmp_path / "a"))
    runner.run(cfg, vort0=makefields.gaussian(cfg),
               manifest_path=str(tmp_path / "log"))
    cfg2 = cfg.replace(output_dir=str(tmp_path / "b"))
    r = runner.run(cfg2, resume_from=tmp_path / "a" / "ckpt_step_5.npz",
                   manifest_path=str(tmp_path / "log2"), record=False)
    assert r.steps_run == 5
    import pytest as _pytest
    with _pytest.raises(ValueError):
        runner.run(cfg2.replace(nx=64, ny=64),
                   resume_from=tmp_path / "a" / "ckpt_step_5.npz",
                   record=False)


def test_blowup_guard_fires(tmp_path):
    """A CFL-violating run must fail loudly at a record boundary with the
    step index, not write NaN fields silently."""
    import pytest as _pytest
    from xlab_fftbarotropic import runner
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.utils.guards import BlowUpError
    cfg = ModelConfig(nx=32, ny=32, dt=1e6, nu=0.0, total_steps=40,
                      record_step=10, output_dir=str(tmp_path / "out"))
    vort0 = makefields.kuo2004(cfg)
    with _pytest.raises(BlowUpError):
        runner.run(cfg, vort0=vort0, manifest_path=str(tmp_path / "log"))


def test_profiling_utils():
    import jax.numpy as jnp
    from xlab_fftbarotropic.utils.profiling import (
        StepTimer, throughput, timed)
    import jax
    f = jax.jit(lambda x: x * 2.0 + 1.0)
    x = jnp.ones((64, 64))
    sec, out = timed(f, x)
    assert sec > 0 and out.shape == (64, 64)
    gps = throughput(f, x, grid_points=64 * 64)
    assert gps > 0
    st = StepTimer(64 * 64)
    rec = st.lap(10)
    assert rec["steps_per_s"] > 0


def test_runner_fd_core(tmp_path):
    """The FD cross-check family runs through the same runner/recorder."""
    import numpy as np
    from xlab_fftbarotropic import runner
    from xlab_fftbarotropic.ic import makefields
    cfg = ModelConfig(nx=32, ny=32, total_steps=10, record_step=5,
                      output_dir=str(tmp_path / "out"))
    r = runner.run(cfg, vort0=makefields.gaussian(cfg), model_kind="fd",
                   manifest_path=str(tmp_path / "log"))
    assert r.steps_run == 10
    assert (tmp_path / "out" / "vort_step_5.bin").exists()
    assert (tmp_path / "out" / "psi_step_5.bin").exists()
    assert np.isfinite(np.asarray(r.zeta_hat[0])).all()


def test_runner_sharded_matches_single(tmp_path):
    """--shard path: the sharded run's recorded fields match the
    single-device run's to float32 tolerance (8 virtual devices)."""
    import jax
    import numpy as np
    if len(jax.devices()) < 2:
        import pytest as _p
        _p.skip("needs multiple devices")
    from xlab_fftbarotropic import runner
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.io.fieldio import read_field
    cfg = ModelConfig(nx=64, ny=64, total_steps=10, record_step=5)
    vort0 = makefields.gaussian(cfg)
    r1 = runner.run(cfg.replace(output_dir=str(tmp_path / "a")), vort0=vort0,
                    manifest_path=str(tmp_path / "la"), collect_stats=False)
    r2 = runner.run(cfg.replace(output_dir=str(tmp_path / "b")), vort0=vort0,
                    manifest_path=str(tmp_path / "lb"), shard=True,
                    collect_stats=False)
    assert r2.steps_run == 10
    a = read_field(tmp_path / "a" / "vort_step_5.bin", cfg.grid_shape)
    b = read_field(tmp_path / "b" / "vort_step_5.bin", cfg.grid_shape)
    np.testing.assert_allclose(b, a, rtol=0, atol=5e-5 * np.abs(a).max())
    # x-pencil decomposition end-to-end through the runner: the padded
    # column-sharded state must record identically (pad never observed)
    r3 = runner.run(cfg.replace(output_dir=str(tmp_path / "c")),
                    vort0=vort0, manifest_path=str(tmp_path / "lc"),
                    shard=True, decomp="xpencil", collect_stats=False)
    assert r3.steps_run == 10
    c = read_field(tmp_path / "c" / "vort_step_5.bin", cfg.grid_shape)
    np.testing.assert_allclose(c, a, rtol=0, atol=5e-5 * np.abs(a).max())


class TestDebugFields:
    def test_debug_dumps_barotropic(self, tmp_path):
        """--debug-fields writes the OUTPUT_GRAD_VORT/OUTPUT_DVORTDT dumps
        (main.cpp:156-176, 216-222): physical zeta gradients and the
        advective tendency BEFORE forward transform + viscosity."""
        import jax.numpy as jnp
        from xlab_fftbarotropic.ops import fft, spectral as sp

        cfg = make_cfg(tmp_path)
        vort0 = makefields.gaussian(cfg)
        run(cfg, vort0, manifest_path=str(tmp_path / "log"),
            debug_fields=True)
        out = tmp_path / "output"
        for step in (0, 5):
            for name in ("dvortdx", "dvortdy", "dvortdt"):
                assert (out / f"{name}_step_{step}.bin").exists(), (name,
                                                                    step)
        # step-0 semantics: dvortdx = irfft2(i kx zeta_hat) of the IC, and
        # dvortdt = -u*zeta_x - v*zeta_y (zero source)
        t = sp.SpectralTables.from_config(cfg)
        zh = fft.forward(jnp.asarray(vort0))
        g = cfg.grid_shape
        dvdx = np.asarray(fft.inverse(sp.gradx(t, zh), g))
        dvdy = np.asarray(fft.inverse(sp.grady(t, zh), g))
        psi_hat = sp.invert_laplacian(t, zh)
        u = -np.asarray(fft.inverse(sp.grady(t, psi_hat), g))
        v = np.asarray(fft.inverse(sp.gradx(t, psi_hat), g))
        np.testing.assert_allclose(
            read_field(out / "dvortdx_step_0.bin", g), dvdx, atol=1e-12)
        np.testing.assert_allclose(
            read_field(out / "dvortdt_step_0.bin", g),
            -u * dvdx - v * dvdy, atol=1e-12)
        # the manifest lists the debug paths (reference appends them to
        # log, main.cpp:158-161)
        log = (tmp_path / "log").read_text()
        assert "dvortdt_step_0.bin" in log

    def test_debug_dumps_shallow_water(self, tmp_path):
        cfg = make_cfg(tmp_path)
        vort0 = makefields.gaussian(cfg)
        run(cfg, vort0, model_kind="sw",
            manifest_path=str(tmp_path / "log"), debug_fields=True)
        out = tmp_path / "output"
        for name in ("dvortdx", "dvortdy", "dvortdt"):
            assert (out / f"{name}_step_0.bin").exists(), name
        dv = read_field(out / "dvortdt_step_0.bin", cfg.grid_shape)
        assert np.isfinite(dv).all()

    def test_debug_rejected_for_fd(self, tmp_path):
        import pytest as _pytest
        cfg = make_cfg(tmp_path)
        vort0 = makefields.gaussian(cfg)
        with _pytest.raises(ValueError, match="debug-fields"):
            run(cfg, vort0, model_kind="fd",
                manifest_path=str(tmp_path / "log"), debug_fields=True)


def test_blowup_still_closes_manifest(tmp_path):
    """ADVICE r1: a BlowUpError mid-run must still close the manifest and
    the source reader (try/finally path)."""
    import pytest as _pytest
    from xlab_fftbarotropic import runner
    from xlab_fftbarotropic.utils.guards import BlowUpError
    cfg = ModelConfig(nx=32, ny=32, dt=1e6, nu=0.0, total_steps=40,
                      record_step=10, output_dir=str(tmp_path / "out"))
    vort0 = makefields.kuo2004(cfg)
    with _pytest.raises(BlowUpError):
        runner.run(cfg, vort0=vort0, manifest_path=str(tmp_path / "log"))
    # manifest closed => contents flushed to disk
    assert (tmp_path / "log").exists()
    text = (tmp_path / "log").read_text()
    assert "vort_step_0.bin" in text


@pytest.mark.parametrize("argv", [
    ["--fast-transforms"],
    ["--shard", "--shard-fft", "overlap"],
    ["--fft-backend", "pallas"],
])
def test_removed_flags_rejected(tmp_path, argv):
    """The flags that selected the removed kernels are gone: argparse
    rejects them (exit 2) instead of falling back to another path."""
    from xlab_fftbarotropic.cli import run as cli_run

    with pytest.raises(SystemExit) as ei:
        cli_run.main(["-O", str(tmp_path / "out"), "--cpu"] + argv)
    assert ei.value.code == 2


def test_settings_banner_names_device(tmp_path, capsys):
    """xfb-run prints the platform, device kind and device count it runs
    on in its settings banner (the CPU here)."""
    import jax

    from xlab_fftbarotropic.cli import run as cli_run

    inp = tmp_path / "input"
    inp.mkdir()
    cfg = ModelConfig(nx=32, ny=32)
    write_field(str(inp / "initial_vorticity.bin"),
                np.asarray(makefields.gaussian(cfg)))
    cli_run.main(["-I", str(inp), "-O", str(tmp_path / "out"),
                  "--nx", "32", "--ny", "32", "--total-steps", "2",
                  "--record-step", "2", "--cpu", "--no-record",
                  "--manifest", str(tmp_path / "log")])
    err = capsys.readouterr().err
    dev = jax.devices()[0]
    assert (f"Device                : {dev.platform} {dev.device_kind} "
            f"x {len(jax.devices())}") in err


def test_profile_dir_flag_writes_trace(tmp_path):
    """xfb-run --profile-dir wraps the run in a jax.profiler trace scope
    and leaves a TensorBoard profile-plugin directory behind."""
    from xlab_fftbarotropic.cli import run as cli_run

    inp = tmp_path / "input"
    inp.mkdir()
    cfg = ModelConfig(nx=32, ny=32, input_dir=str(inp),
                      output_dir=str(tmp_path / "out"))
    write_field(str(inp / "initial_vorticity.bin"),
                np.asarray(makefields.gaussian(cfg)))
    trace_dir = tmp_path / "trace"
    cli_run.main(["-I", str(inp), "-O", str(tmp_path / "out"),
                  "--nx", "32", "--ny", "32", "--total-steps", "2",
                  "--record-step", "2", "--cpu",
                  "--profile-dir", str(trace_dir),
                  "--manifest", str(tmp_path / "log")])
    prof = trace_dir / "plugins" / "profile"
    assert prof.is_dir() and any(prof.iterdir())


def test_step_banner_parity(tmp_path, capsys):
    """--step-banners restores the reference's EVERY-step stderr banner
    (main.cpp:262-264): one '# Step N, time = T' line per step, with the
    ', record now!' suffix exactly at record boundaries."""
    cfg = make_cfg(tmp_path)
    vort0 = makefields.gaussian(cfg)
    run(cfg, vort0, manifest_path=str(tmp_path / "log"),
        step_banners=True)
    err = [ln for ln in capsys.readouterr().err.splitlines()
           if ln.startswith("# Step ")]
    # reference prints steps 0..total_steps-1; scan segments emit their
    # banners in bursts, but content and per-line format must match
    assert sorted(err) != []
    by_step = {}
    for ln in err:
        n = int(ln.split()[2].rstrip(","))
        by_step[n] = ln
    assert sorted(by_step) == list(range(cfg.total_steps))
    for n, ln in by_step.items():
        expect = f"# Step {n}, time = {n * cfg.dt:.2f}"
        if n % cfg.record_step == 0:
            expect += ", record now!"
        assert ln == expect, ln


def test_record_fields_subset(tmp_path):
    """--record-fields limits the record set (and the device→host gather
    volume); 'vort_src' gates the forcing dump; unknown names raise."""
    import pytest

    cfg = make_cfg(tmp_path)
    vort0 = makefields.gaussian(cfg)
    run(cfg, vort0, manifest_path=str(tmp_path / "log"),
        record_only=["vort", "psi"])
    out = tmp_path / "output"
    for step in (0, 5):
        for name in ("vort", "psi"):
            assert (out / f"{name}_step_{step}.bin").exists(), (name, step)
        for name in ("u", "v", "vort_src_input"):
            assert not (out / f"{name}_step_{step}.bin").exists(), (
                name, step)
    # recorded subset is identical to the full run's fields
    full = tmp_path / "full"
    cfg2 = make_cfg(tmp_path, output_dir=str(full))
    run(cfg2, vort0, manifest_path=str(tmp_path / "log2"))
    for name in ("vort", "psi"):
        a = read_field(out / f"{name}_step_5.bin", cfg.grid_shape)
        b = read_field(full / f"{name}_step_5.bin", cfg.grid_shape)
        np.testing.assert_array_equal(a, b)

    with pytest.raises(ValueError, match="unknown field"):
        run(make_cfg(tmp_path, output_dir=str(tmp_path / "o3")), vort0,
            manifest_path=str(tmp_path / "log3"),
            record_only=["vort", "nope"])


def _gather_cases():
    rng = np.random.default_rng(0)
    return {
        "real": rng.standard_normal((1024, 1024)).astype(np.float32),
        "complex": (rng.standard_normal((1024, 513)) + 1j *
                    rng.standard_normal((1024, 513))).astype(np.complex64),
        "batched": rng.standard_normal((3, 512, 512)).astype(np.float32),
        "odd": rng.standard_normal((37, 19)).astype(np.float32),
    }


@pytest.mark.parametrize("case", ["real", "complex", "batched", "odd"])
def test_gather_to_host_matches_asarray(case):
    """gather_to_host of a device array (records, checkpoints, spectral
    states — 4 MB here) is exactly np.asarray, dtype and shape included."""
    import jax.numpy as jnp

    from xlab_fftbarotropic.parallel import multihost

    a = _gather_cases()[case]
    got = multihost.gather_to_host(jnp.asarray(a))
    assert isinstance(got, np.ndarray)
    assert got.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(got, a)


def test_gather_to_host_sharded_array():
    """A row-sharded array over the 8 virtual devices (fully addressable
    in one process) gathers to the same host array."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from xlab_fftbarotropic.parallel import make_mesh, multihost

    a = _gather_cases()["complex"]
    mesh = make_mesh(jax.devices())
    x = jax.device_put(a, NamedSharding(mesh, P("x", None)))
    np.testing.assert_array_equal(multihost.gather_to_host(x), a)


def test_cli_empty_record_fields_rejected(tmp_path):
    """--record-fields with an empty/whitespace value must error (argparse
    exit 2), not silently record nothing (round-3 ADVICE)."""
    import pytest

    from xlab_fftbarotropic.cli import run as cli_run

    with pytest.raises(SystemExit) as ei:
        cli_run.main(["-O", str(tmp_path / "out"), "--cpu",
                      "--record-fields", " , "])
    assert ei.value.code == 2
