"""Multi-host execution: process initialization and pod-aware meshes.

Reference analog: the reference scales past one machine through a shared
filesystem + FaaS workers (faasTest/README.md, benchmark/pkg/faas) — its
"cluster" is OpenLambda containers mounting one volume.  The JAX
equivalent is SPMD over several processes: every process runs this same
program, `jax.distributed` coordinates, data-parallel shards live
process-local, and the exchanges are device collectives (NCCL on GPUs).

What lives here:
  * :func:`initialize_distributed` — env-driven `jax.distributed` bring-up
    (idempotent; no-op single-process).
  * :func:`pod_key_mesh` — 1D key mesh ordered host-major, so shard i sits
    on host i // chips_per_host: the storage plane's per-host spill files
    and the sort's contiguous output ranges then align with host locality,
    and each LSD/PSRS exchange crosses hosts only for rows that actually
    change hosts.
  * :func:`process_shard_bounds` — which slice of a global array this host
    owns (for per-host IO: each host feeds/drains only its own rows, the
    multi-host replacement for the reference's shared-volume rendezvous).

The sort/aggregate kernels themselves need no changes: shard_map over the
mesh compiles identical programs on every host, and the capacity-bounded
all-to-all lowers to device collectives.  Scaling validation on
real multi-host hardware is a bench-harness run of the same entry points
with `initialize_distributed()` called first (BASELINE.json config 4); CI
validates the SPMD program shape on a virtual device mesh instead
(__graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import os

import numpy as np

from .mesh import KEY_AXIS


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Bring up jax.distributed from args or env (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID, falling back to JAX's own cluster
    autodetection).  Returns True if a multi-process runtime is active.
    Idempotent; safe to call single-process (returns False)."""
    import jax

    # Decide from env/args FIRST: jax.process_count() initializes the XLA
    # backends, and jax.distributed.initialize() must run before any JAX
    # computation — probing process_count up front would guarantee the
    # bring-up below fails on a real pod.
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("JAX_PROCESS_ID")
    if not coordinator and num_processes is None:
        return jax.process_count() > 1  # single-process / autodetected run
    if not jax.distributed.is_initialized():
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_count() > 1


def _int_env(name: str) -> int | None:
    raw = os.environ.get(name)
    return int(raw) if raw is not None else None


def pod_key_mesh(devices=None):
    """1D key mesh with devices ordered host-major (process-major): the
    global key order maps to host 0's chips, then host 1's, … so a sorted
    output's contiguous ranges align with hosts."""
    import jax
    from jax.sharding import Mesh

    devices = list(devices if devices is not None else jax.devices())
    devices.sort(key=lambda d: (d.process_index, getattr(d, "id", 0)))
    return Mesh(np.asarray(devices), (KEY_AXIS,))


def process_shard_bounds(n_global: int, mesh=None) -> tuple[int, int]:
    """[lo, hi) rows of a length-n_global key-sharded array owned by this
    process under ``pod_key_mesh`` ordering — the per-host IO range
    replacing the reference's shared-volume rendezvous."""
    import jax

    mesh = mesh if mesh is not None else pod_key_mesh()
    devs = list(mesh.devices.reshape(-1))
    nchips = len(devs)
    per_chip = -(-n_global // nchips)
    mine = [i for i, d in enumerate(devs)
            if d.process_index == jax.process_index()]
    if not mine:
        return (0, 0)
    # Clamp both ends to the array: with uneven per-chip padding a tail
    # host's nominal range can start past n_global — it then owns nothing.
    lo = min(min(mine) * per_chip, n_global)
    hi = min((max(mine) + 1) * per_chip, n_global)
    return (lo, max(hi, lo))
