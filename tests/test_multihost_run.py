"""End-to-end two-process sharded run (the ADVICE r1 medium scenario).

test_multihost.py proves bring-up + gather_to_host; this test drives the
FULL runner across 2 real jax.distributed CPU processes sharing one
output directory — the configuration the advisor flagged as "crashes or
races at the first record/checkpoint boundary" before the rank gating
landed. Every process executes the collective gathers; only rank 0 may
touch the record/manifest/checkpoint files, and the recorded fields must
match a single-process unsharded run to float32 round-off.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)   # one device per process
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from xlab_fftbarotropic.parallel import multihost
    from xlab_fftbarotropic import runner
    from xlab_fftbarotropic.config import ModelConfig

    workdir = sys.argv[1]
    assert multihost.initialize() is True
    rank = jax.process_index()
    assert multihost.is_primary() == (rank == 0)
    assert len(jax.devices()) == 2          # global mesh: 1 chip/process

    cfg = ModelConfig(nx=32, ny=32, total_steps=4, record_step=2,
                      checkpoint_step=2,
                      input_dir=os.path.join(workdir, "input"),
                      output_dir=os.path.join(workdir, "output"))
    # shard=True => slab mesh over BOTH processes' devices; the record/
    # checkpoint gathers are collectives on every rank, file writes are
    # rank-0-only (runner.py multi-process discipline)
    runner.run(cfg, shard=True,
               manifest_path=os.path.join(workdir, "log"))
    print(f"RANK{rank}_DONE", flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_run_records_once(tmp_path):
    from xlab_fftbarotropic import runner
    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.io.fieldio import read_field, write_field

    # shared IC on disk, exactly like a pod run's shared filesystem
    (tmp_path / "input").mkdir()
    cfg0 = ModelConfig(nx=32, ny=32)
    write_field(str(tmp_path / "input" / "initial_vorticity.bin"),
                np.asarray(makefields.gaussian(cfg0)))

    # single-process unsharded reference
    ref_cfg = ModelConfig(nx=32, ny=32, total_steps=4, record_step=2,
                          input_dir=str(tmp_path / "input"),
                          output_dir=str(tmp_path / "ref_output"))
    runner.run(ref_cfg, manifest_path=str(tmp_path / "ref_log"))

    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update(XFB_COORDINATOR=f"127.0.0.1:{port}",
                   XFB_NUM_PROCESSES="2", XFB_PROCESS_ID=str(rank),
                   JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(REPO) + os.pathsep
                   + env.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{err[-3000:]}"
        assert f"RANK{rank}_DONE" in out

    # the shared dir holds exactly one manifest + record set, matching
    # the unsharded reference to float32 round-off
    assert (tmp_path / "log").exists()
    for name in ("vort_step_0.bin", "vort_step_2.bin", "psi_step_0.bin",
                 "u_step_2.bin", "v_step_2.bin"):
        got = read_field(tmp_path / "output" / name, (32, 32))
        want = read_field(tmp_path / "ref_output" / name, (32, 32))
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got, want, atol=1e-5 * scale,
                                   err_msg=name)
    assert (tmp_path / "output" / "ckpt_step_2.npz").exists()
