"""Multi-host bootstrap (SURVEY.md §6 "failure detection / elastic
recovery" row: multi-host init via jax.distributed).

The reference is a single process (SURVEY.md §2); multi-host execution is
a new capability. The model path needs nothing special — `make_mesh` /
`make_mesh2d` over `jax.devices()` already sees the GLOBAL device set once
the distributed runtime is up — so all this module does is make that
bring-up explicit, env-driven, and idempotent, and give restarts a clean
re-entry (the checkpoint/resume path in io/checkpoint.py is per-run state;
process topology comes from here).

Environment contract (a subset of the common cluster launchers'):
  XFB_COORDINATOR   host:port of process 0 (also accepts
                    JAX_COORDINATOR_ADDRESS)
  XFB_NUM_PROCESSES total process count   (also JAX_NUM_PROCESSES)
  XFB_PROCESS_ID    this process's rank   (also JAX_PROCESS_ID)
Where the cluster environment lets plain `jax.distributed.initialize()`
discover everything itself, set only XFB_MULTIHOST=1 to request that
path.
"""

from __future__ import annotations

import os
from typing import Optional


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Bring up jax.distributed if configured; return True when running
    multi-process after the call.

    Priority: explicit args > XFB_*/JAX_* env > cluster auto-discovery
    (XFB_MULTIHOST=1). With none of these present this is a no-op
    returning False — single-process runs never pay for it. Idempotent:
    a second call on an initialized runtime is a no-op."""
    import jax

    # Idempotency must be checked WITHOUT touching the XLA backend:
    # jax.process_count() initializes the backend, after which
    # jax.distributed.initialize() refuses to run ("must be called before
    # any JAX calls") — caught by tests/test_multihost.py's real
    # two-process smoke.
    if jax.distributed.is_initialized():
        return jax.process_count() > 1

    env = os.environ
    coordinator = (coordinator or env.get("XFB_COORDINATOR")
                   or env.get("JAX_COORDINATOR_ADDRESS"))
    nproc = num_processes if num_processes is not None else int(
        env.get("XFB_NUM_PROCESSES", env.get("JAX_NUM_PROCESSES", 0)) or 0)
    pid = process_id if process_id is not None else (
        int(env["XFB_PROCESS_ID"]) if "XFB_PROCESS_ID" in env
        else int(env["JAX_PROCESS_ID"]) if "JAX_PROCESS_ID" in env
        else None)

    if coordinator and nproc:
        if pid is None:
            raise RuntimeError(
                "multihost: XFB_COORDINATOR/XFB_NUM_PROCESSES are set but "
                "the process rank is missing — set XFB_PROCESS_ID (or "
                "JAX_PROCESS_ID) to this process's rank in [0, "
                f"{nproc}). Without a cluster environment the rank "
                "cannot be auto-discovered.")
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=nproc,
                                   process_id=pid)
        return jax.process_count() > 1
    if env.get("XFB_MULTIHOST"):
        jax.distributed.initialize()  # cluster auto-discovery
        return jax.process_count() > 1
    return False


def is_primary() -> bool:
    """True on the process that should own host-side I/O (manifest,
    checkpoints, record files) — rank 0, or any single-process run."""
    import jax

    return jax.process_index() == 0


def gather_to_host(x):
    """Materialize an array on this host as numpy, even when it is a
    global sharded array whose shards live on other processes.

    Single-process (and any fully-addressable array): plain np.asarray.
    Multi-process: an allgather collective — EVERY process must call this
    on the same array in the same order, so callers (runner adapters)
    invoke it unconditionally and gate only the file writes on
    is_primary()."""
    import numpy as np

    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
