"""Pod-scale compile-only regression gate.

Spawns subprocesses (device count must be fixed before jax initializes) at
P=8 and P=64 and asserts the sharded programs' HLO size stays ~flat — the
``send_windows`` P-independence claim (parallel/exchange.py:54-70) that
keeps pod-slice programs (BASELINE.json config 4) compilable.  Compile
TIME is recorded to docs by bench/podscale.py runs, not asserted here
(wall time on a 1-core box is too noisy to gate on).
"""

import json
import os
import subprocess
import sys

import pytest

# One HLO-chars table per session; the subprocesses are ~20s each.
_CACHE: dict[int, dict[str, dict]] = {}


def _podscale(devices: int) -> dict[str, dict]:
    if devices not in _CACHE:
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
        )
        proc = subprocess.run(
            [sys.executable, "-m", "gpu_radix_sort_tpu.bench.podscale",
             "--devices", str(devices), "--json"],
            capture_output=True, text=True, env=env, timeout=900,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        _CACHE[devices] = {
            rec["program"]: rec
            for rec in map(json.loads, proc.stdout.splitlines())
        }
    return _CACHE[devices]


@pytest.mark.slow
def test_pod_scale_hlo_stays_flat():
    base = _podscale(8)
    pod = _podscale(64)
    assert set(pod) == set(base) and len(base) == 5
    for name, rec in pod.items():
        ratio = rec["hlo_chars"] / base[name]["hlo_chars"]
        # 8x the devices must not grow the program more than 30% (measured
        # ~2%; an unrolled per-peer loop regression shows up as ~8x).
        assert ratio < 1.3, (name, ratio, rec, base[name])
