"""chip_smoke.py's pure parts: sizes and cuts, the phase and result lines,
argument checks, the numpy oracles it trusts, and that it refuses to run
without a GPU.  The phases themselves run on the card
(``python chip_smoke.py``); one of them is rehearsed here on the CPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("log2n,shrink,n", [(30, 0, 1 << 30), (28, 1, 1 << 27),
                                            (26, 4, 1 << 22)])
def test_cut_size(log2n, shrink, n):
    got, note = cs.cut_size(log2n, shrink)
    assert got == n
    assert (note is None) == (shrink == 0)
    if shrink:
        assert f"2^{log2n - shrink}" in note


@pytest.mark.parametrize("shrink", [-1, 30, 31])
def test_cut_size_rejects(shrink):
    with pytest.raises(ValueError):
        cs.cut_size(30, shrink)


def test_full_sizes_fit_the_index_math():
    # single-card phases up to 2^30 keys; the mesh's global n stays < 2^31
    assert max(cs.SINGLE_SIZES.values()) == 30
    assert all((1 << v) * 4 < (1 << 31) for v in cs.MESH_SIZES.values())


def test_result_line_exact_format():
    line = cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_phase_line_fields():
    line = cs.phase_line("sort_full_u32", 8, 32, 0.5, 0.25, 64, True,
                         "2^3 cut", cards=4)
    tag, rec = line.split(" ", 1)
    rec = json.loads(rec)
    assert tag == "phase"
    assert rec == {"name": "sort_full_u32", "n": 8, "cards": 4,
                   "device_bytes": 32, "compile_s": 0.5, "run_s": 0.25,
                   "peak_bytes_in_use": 64, "exact": True, "cut": "2^3 cut"}


@pytest.mark.parametrize("argv,mesh", [([], 0), (["--mesh", "4"], 4)])
def test_parse_args(argv, mesh):
    assert cs.parse_args(argv).mesh == mesh


@pytest.mark.parametrize("argv", [["--mesh", "1"], ["--mesh", "-2"]])
def test_parse_args_rejects_bad_mesh(argv):
    with pytest.raises(SystemExit):
        cs.parse_args(argv)


def test_stable_order_check_accepts_stable_argsort():
    keys = np.random.default_rng(0).integers(0, 8, 4096).astype(np.uint32)
    order = np.argsort(keys, kind="stable")
    assert cs._stable_order_ok(keys, keys[order], order)


@pytest.mark.parametrize("break_it", ["unstable", "duplicate", "keys"])
def test_stable_order_check_rejects(break_it):
    keys = np.random.default_rng(1).integers(0, 8, 4096).astype(np.uint32)
    order = np.argsort(keys, kind="stable")
    out = keys[order].copy()
    if break_it == "unstable":
        order[[0, 1]] = order[[1, 0]]  # two rows of one key swapped
    elif break_it == "duplicate":
        order[1] = order[0]
    else:
        out[-1] ^= 1
    assert not cs._stable_order_ok(keys, out, order)


def test_payload_lanes_match_numpy():
    import jax.numpy as jnp

    idx = np.arange(100, dtype=np.uint32)
    got = np.asarray(cs._payload_lanes(jnp.asarray(idx), 16))
    np.testing.assert_array_equal(got, cs._payload_lanes_np(idx, 16))
    np.testing.assert_array_equal(got[:, 0], idx)


def test_single_card_phases_rehearsed_on_cpu(monkeypatch):
    import jax

    monkeypatch.setattr(cs.Smoke, "peak", lambda self: 0)
    s = cs.Smoke(jax.devices("cpu")[:1], seed=0, shrink=18)
    cs.single_card_phases(s)


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_exits_nonzero_without_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_sort_full_lands_on_cub_radix_sort(gpu_device):
    """On a GPU the u32 full sort is one CUB radix-sort custom call in the
    optimised HLO, not XLA's own sort kernel."""
    import jax
    import jax.numpy as jnp

    import gpu_radix_sort_tpu as gst

    x = jax.device_put(jnp.arange(1 << 16, dtype=jnp.uint32)[::-1],
                       gpu_device)
    text = jax.jit(gst.sort_full).lower(x).compile().as_text()
    assert "DeviceRadixSort" in text
