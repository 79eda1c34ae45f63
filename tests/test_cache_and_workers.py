"""The compile-cache rule (utils/cache.py) and the device ownership of
subprocess workers (parallel/serverless.py)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from gpu_radix_sort_tpu.parallel import serverless
from gpu_radix_sort_tpu.utils import cache

REPO = Path(__file__).resolve().parent.parent


# --- compile cache ------------------------------------------------------------

def test_cache_dir_from_environment_is_kept():
    path, must_set = cache.compile_cache_dir({cache.ENV: "/some/where"})
    assert path == "/some/where" and not must_set


@pytest.mark.parametrize("environ", [{}, {cache.ENV: ""}])
def test_cache_dir_defaults_to_checkout(environ):
    path, must_set = cache.compile_cache_dir(environ)
    assert must_set
    assert Path(path) == REPO / ".jax_cache"


def test_cache_dir_is_gitignored():
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def _cache_in_child(env_extra: dict) -> list[str]:
    env = {k: v for k, v in os.environ.items()
           if k not in (cache.ENV, "JAX_ENABLE_COMPILATION_CACHE")}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    code = ("import jax; from gpu_radix_sort_tpu.utils.cache import "
            "enable_compile_cache as e; p = e(); "
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.split()


def test_enable_compile_cache_default_in_process():
    helper, jax_dir = _cache_in_child({})
    assert helper == jax_dir == str(REPO / ".jax_cache")


def test_enable_compile_cache_respects_environment(tmp_path):
    helper, jax_dir = _cache_in_child({cache.ENV: str(tmp_path)})
    assert helper == jax_dir == str(tmp_path)


@pytest.mark.parametrize("entry", ["chip_smoke.py", "bench.py",
                                   "gpu_radix_sort_tpu/cli.py",
                                   "benchmarks/run_out_of_core.py"])
def test_entry_points_use_the_cache_rule(entry):
    assert "enable_compile_cache()" in (REPO / entry).read_text()


# --- subprocess worker device ownership ----------------------------------------

def test_cpu_worker_sees_no_card():
    env = serverless._worker_env("/m", "cpu", None)
    assert env["JAX_PLATFORMS"] == "cpu"
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env[serverless.MOUNT_ENV] == "/m"


@pytest.mark.parametrize("gpu", [0, 3])
def test_gpu_worker_pinned_to_one_card(gpu):
    env = serverless._worker_env("/m", "gpu", None, gpu)
    assert env["JAX_PLATFORMS"] == "cuda"
    assert env["CUDA_VISIBLE_DEVICES"] == str(gpu)


def test_gpu_worker_needs_its_card():
    with pytest.raises(ValueError, match="card"):
        serverless._worker_env("/m", "gpu", None)
    with pytest.raises(ValueError, match="card"):
        serverless._worker_env("/m", "cpu", None, 0)
    with pytest.raises(ValueError, match="card"):
        serverless.make_subprocess_worker("/m", platform="gpu")


def test_unknown_platform_rejected():
    with pytest.raises(ValueError, match="platform"):
        serverless._worker_env("/m", "rocm", None)


def test_defaults_are_cpu_workers():
    import inspect

    for fn in (serverless.invoke_subprocess, serverless.make_subprocess_worker,
               serverless.WorkerPool.__init__):
        assert inspect.signature(fn).parameters["platform"].default == "cpu"


@pytest.mark.parametrize("gpus", [None, [0], [0, 0], [0, 1, 2]])
def test_gpu_pool_needs_one_distinct_card_per_worker(tmp_path, gpus):
    with pytest.raises(ValueError, match="distinct card"):
        serverless.WorkerPool(str(tmp_path), size=2, platform="gpu",
                              gpus=gpus)


def test_cpu_pool_takes_no_cards(tmp_path):
    with pytest.raises(ValueError, match="gpus"):
        serverless.WorkerPool(str(tmp_path), size=1, gpus=[0])
