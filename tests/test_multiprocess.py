"""True cross-process collective execution.

Spawns TWO OS processes, each a `jax.distributed` participant with 4
virtual CPU devices, and runs the mesh sort paths (fused-LSD alltoall +
PSRS) over the resulting 8-device global runtime — collectives crossing a
REAL process boundary, the analog of the reference's FaaS process boundary
(reference benchmark/pkg/faas/invoke.go:118-171).  Everything else
in tests/ exercises the mesh plane inside one process; this is the one
place cross-process device-to-device exchange actually executes.

The child program is tests/mp_child.py (asserts exactness per addressable
shard and process_shard_bounds with a real nonzero process_index).
"""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
CHILD = Path(__file__).resolve().parent / "mp_child.py"
NPROC = 2
NDEV = 4  # per process -> 8 global devices


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    want = f"--xla_force_host_platform_device_count={NDEV}"
    if "xla_force_host_platform_device_count" in flags:
        flags = re.sub(
            r"--xla_force_host_platform_device_count=\d+", want, flags
        )
    else:
        flags = (flags + " " + want).strip()
    env["XLA_FLAGS"] = flags
    # `python path/to/script.py` puts the SCRIPT's dir on sys.path, not the
    # cwd — the package import needs the repo root explicitly.
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # No ambient coordination state may leak into the children.
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        env.pop(k, None)
    return env


@pytest.mark.slow
def test_two_process_collectives_exact():
    port = _free_port()
    env = _child_env()
    procs = [
        subprocess.Popen(
            [sys.executable, str(CHILD), str(pid), str(NPROC), str(port),
             str(NDEV)],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(NPROC)
    ]
    # Drain BOTH children concurrently: the processes must progress
    # together through collectives, and a sequential communicate() on
    # child 0 would leave child 1's pipes unread — verbose logging could
    # fill the ~64KB pipe buffer and deadlock both into the timeout.
    from concurrent.futures import ThreadPoolExecutor

    try:
        with ThreadPoolExecutor(max_workers=NPROC) as pool:
            futs = [pool.submit(p.communicate, timeout=600) for p in procs]
            drained = [f.result(timeout=620) for f in futs]
            # returncode only AFTER communicate() returned for that child
            outs = [
                (p.returncode, out, err)
                for p, (out, err) in zip(procs, drained)
            ]
    except Exception:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail("2-process jax.distributed children timed out (600s)")
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, (
            f"child {pid} exited {rc}\nstdout:\n{out}\nstderr:\n{err[-4000:]}"
        )
        assert f"CHILD_OK {pid}" in out, (pid, out, err[-4000:])
