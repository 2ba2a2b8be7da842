"""Tests for field IO, the manifest, forcing streams, and checkpointing."""

import io
import os
import threading
import time

import numpy as np
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.forcing import source as fsrc
from xlab_fftbarotropic.io import checkpoint as ckpt
from xlab_fftbarotropic.io.fieldio import (FieldRecorder, Manifest,
                                               read_field, write_field)


class TestFieldIO:
    def test_roundtrip(self, tmp_path, rng):
        data = rng.randn(32, 16).astype(np.float32)
        p = tmp_path / "f.bin"
        write_field(p, data)
        # byte contract: raw little-endian f4, x-major (fieldio.cpp:7-19)
        raw = np.fromfile(p, dtype="<f4")
        np.testing.assert_array_equal(raw, data.reshape(-1))
        back = read_field(p, (32, 16))
        np.testing.assert_array_equal(back, data)

    def test_missing_file_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            read_field(tmp_path / "nope.bin", (4, 4))

    def test_short_file_raises(self, tmp_path):
        p = tmp_path / "short.bin"
        np.zeros(3, np.float32).tofile(p)
        with pytest.raises(IOError):
            read_field(p, (4, 4))

    def test_recorder_and_manifest(self, tmp_path, rng):
        f = rng.randn(8, 8).astype(np.float32)
        man_path = tmp_path / "log"
        with Manifest(man_path) as man:
            rec = FieldRecorder(tmp_path / "out", man)
            rec.record(0, vort_src=f, vort=f, psi=f, u=f, v=f)
            rec.record(100, vort=f)
        lines = man_path.read_text().splitlines()
        # reference write order within a record step (SURVEY.md §5.9)
        assert [os.path.basename(l) for l in lines] == [
            "vort_src_input_step_0.bin", "vort_step_0.bin", "psi_step_0.bin",
            "u_step_0.bin", "v_step_0.bin", "vort_step_100.bin"]
        for l in lines:
            assert os.path.exists(l)


class TestFifoProtocol:
    def test_write_read_roundtrip(self, rng):
        cfg = ModelConfig(nx=8, ny=8)
        f1 = rng.randn(8, 8).astype(np.float32)
        buf = io.BytesIO()
        fsrc.write_step(buf, None)         # flag 0
        fsrc.write_step(buf, f1)           # flag 1 + field
        fsrc.write_step(buf, None)
        buf.seek(0)

        reader = fsrc.FifoSourceReader.__new__(fsrc.FifoSourceReader)
        reader.cfg = cfg
        reader._fd = buf
        changed, field = reader.read(0.0)
        assert not changed and field is None
        changed, field = reader.read(1.0)
        assert changed
        np.testing.assert_array_equal(field, f1)
        changed, field = reader.read(2.0)
        assert not changed
        # stream exhausted -> reference fallback "assume flag = 0"
        changed, field = reader.read(3.0)
        assert not changed

    def test_real_fifo(self, tmp_path, rng):
        """Producer thread + reader across a real UNIX FIFO, as in
        test/02-test_invert_pressure/example.sh:10-13."""
        cfg = ModelConfig(nx=16, ny=16)
        fifo = tmp_path / "vort_src_fifo"
        os.mkfifo(fifo)
        f1 = rng.randn(16, 16).astype(np.float32)

        def producer():
            with open(fifo, "wb") as w:
                fsrc.write_step(w, None)
                fsrc.write_step(w, f1)
                fsrc.write_step(w, None)

        th = threading.Thread(target=producer)
        th.start()
        reader = fsrc.FifoSourceReader(cfg, fifo)
        assert reader.read(0.0)[0] is False
        changed, field = reader.read(1.0)
        assert changed
        np.testing.assert_array_equal(field, f1)
        assert reader.read(2.0)[0] is False
        th.join()
        reader.close()


    def test_threaded_fifo_prefetch(self, tmp_path, rng):
        """ThreadedFifoReader (the no-native fallback): same protocol
        semantics as FifoSourceReader, one-step lookahead, and close()
        returns promptly even with the prefetch thread blocked on an
        idle pipe."""
        cfg = ModelConfig(nx=16, ny=16)
        fifo = tmp_path / "vort_src_fifo"
        os.mkfifo(fifo)
        f1 = rng.randn(16, 16).astype(np.float32)
        hold = threading.Event()

        def producer():
            with open(fifo, "wb") as w:
                fsrc.write_step(w, None)
                fsrc.write_step(w, f1)
                fsrc.write_step(w, None)
                w.flush()
                hold.wait(timeout=10)      # keep the pipe open (no EOF)

        th = threading.Thread(target=producer)
        th.start()
        reader = fsrc.ThreadedFifoReader(cfg, fifo)
        assert reader.read(0.0)[0] is False
        changed, field = reader.read(1.0)
        assert changed
        np.testing.assert_array_equal(field, f1)
        assert reader.read(2.0)[0] is False
        # prefetch thread is now blocked in read(2) on the open pipe;
        # close() must not hang on it
        t0 = time.monotonic()
        reader.close()
        assert time.monotonic() - t0 < 2.0
        hold.set()
        th.join()

    def test_kuo2004_pulse_stream_schedule(self):
        cfg = ModelConfig(nx=8, ny=8, dt=3.0, total_steps=int(6 * 3600 / 3))
        beg = int(2 * 3600 / 3.0)
        end = int(5 * 3600 / 3.0)
        stream = fsrc.kuo2004_pulse_stream(cfg)
        for step, field in zip(range(1, cfg.total_steps), stream):
            if step == beg:
                assert field is not None and field.max() > 0
            elif step == end:
                assert field is not None and np.all(field == 0)
            else:
                assert field is None


class TestScriptMode:
    def test_script_recipe(self, tmp_path, rng):
        """The SCRIPT mode the reference documents but stubbed
        (vorticity_source.cpp:13-21,100-110), implemented for real."""
        cfg = ModelConfig(nx=8, ny=8, dt=3.0)
        fa = rng.randn(8, 8).astype(np.float32)
        fb = rng.randn(8, 8).astype(np.float32)
        write_field(tmp_path / "a.bin", fa)
        write_field(tmp_path / "b.bin", fb)
        script = tmp_path / "recipe.txt"
        script.write_text(
            "# forcing recipe\n"
            "0.0 a.bin\n"
            "30.0 b.bin  # switch at t=30s\n")
        r = fsrc.ScriptSourceReader(cfg, script)
        changed, f = r.read(0.0)
        assert changed
        np.testing.assert_array_equal(f, fa)
        assert r.read(15.0)[0] is False
        changed, f = r.read(30.0)
        assert changed
        np.testing.assert_array_equal(f, fb)
        assert r.read(60.0)[0] is False


class TestCheckpoint:
    def test_roundtrip_and_hash_guard(self, tmp_path, rng):
        cfg = ModelConfig(nx=16, ny=16)
        z = (rng.randn(16, 9) + 1j * rng.randn(16, 9)).astype(np.complex64)
        p = tmp_path / "ck.npz"
        ckpt.save_checkpoint(p, cfg, z, step=42)
        z2, step, saved = ckpt.load_checkpoint(p, cfg)
        assert step == 42
        np.testing.assert_array_equal(z2, z)
        with pytest.raises(ValueError):
            ckpt.load_checkpoint(p, cfg.replace(nx=32))


def test_forcing_producer_never_imports_jax(tmp_path):
    """xfb-vort-src-input computes with numpy alone: it must not import
    JAX, so it can never claim the accelerator its consumer runs on."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "from xlab_fftbarotropic.cli import vort_src_input as v\n"
        "sys.stdout = open(sys.argv[1], 'w')\n"
        "v.main(['--nx', '16', '--ny', '16', '--total-steps', '4'])\n"
        "sys.stdout.close()\n"
        "sys.exit(3 if 'jax' in sys.modules else 0)\n")
    out = tmp_path / "stream.bin"
    r = subprocess.run([sys.executable, "-c", code, str(out)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
