"""Native C++ runtime tests: field I/O parity and the FIFO prefetch reader
driven end-to-end through a real named pipe with a producer thread."""

import ctypes
import os
import threading

import numpy as np
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.io import fieldio, native_stream

pytestmark = pytest.mark.skipif(
    not native_stream.ensure_built(), reason="native toolchain unavailable")


def test_native_fieldio_roundtrip(tmp_path, rng):
    # force the native path (fieldio auto-detects the .so)
    fieldio._NATIVE_TRIED = False
    data = rng.randn(32, 16).astype(np.float32)
    p = tmp_path / "f.bin"
    fieldio.write_field(p, data)
    assert fieldio._NATIVE is not None, "native lib not picked up"
    back = fieldio.read_field(p, (32, 16))
    np.testing.assert_array_equal(back, data)
    # byte-level: little-endian f4, x-major — same as np.tofile
    raw = np.fromfile(p, dtype="<f4").reshape(32, 16)
    np.testing.assert_array_equal(raw, data)


def test_native_fieldio_short_file_errors(tmp_path):
    p = tmp_path / "short.bin"
    np.zeros(10, np.float32).tofile(p)
    with pytest.raises(IOError):
        fieldio.read_field(p, (32, 16))


def test_native_fifo_protocol(tmp_path, rng):
    cfg = ModelConfig(nx=16, ny=16)
    fifo = tmp_path / "src_fifo"
    os.mkfifo(fifo)
    f0 = rng.randn(16, 16).astype(np.float32)
    f1 = rng.randn(16, 16).astype(np.float32)

    def produce():
        fd = os.open(fifo, os.O_WRONLY)
        try:
            native_stream.native_write_step(fd, f0)   # step 0: new field
            native_stream.native_write_step(fd, None)  # step 1: keep
            native_stream.native_write_step(fd, f1)   # step 2: new field
        finally:
            os.close(fd)

    t = threading.Thread(target=produce)
    t.start()
    r = native_stream.NativeFifoReader(fifo, cfg.grid_shape)
    try:
        changed, field = r.read(0.0)
        assert changed
        np.testing.assert_array_equal(field, f0)
        changed, field = r.read(1.0)
        assert not changed
        changed, field = r.read(2.0)
        assert changed
        np.testing.assert_array_equal(field, f1)
        # producer closed: underrun => flag=0 forever (reference fallback)
        changed, field = r.read(3.0)
        assert not changed
    finally:
        t.join()
        r.close()


def test_make_reader_prefers_native(tmp_path):
    from xlab_fftbarotropic.forcing.source import make_reader
    cfg = ModelConfig(nx=8, ny=8)
    fifo = tmp_path / "fifo2"
    os.mkfifo(fifo)

    def produce():
        fd = os.open(fifo, os.O_WRONLY)
        native_stream.native_write_step(fd, None)
        os.close(fd)

    t = threading.Thread(target=produce)
    t.start()
    r = make_reader(cfg, "fifo", fifo)
    try:
        assert isinstance(r, native_stream.NativeFifoReader)
        changed, _ = r.read(0.0)
        assert not changed
    finally:
        t.join()
        r.close()
