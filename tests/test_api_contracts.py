"""Regression tests for contract fixes from the round-2 self-review
batches: explicit-strategy surfacing, empty PartRef reads, shared-registry
locking, native range validation, transfer limits, CLI env precedence."""

import threading

import numpy as np
import pytest

from gpu_radix_sort_tpu.data import MemArrayFactory, create_shape
from gpu_radix_sort_tpu.data.interface import PartRef


def test_sort_full_explicit_pallas_radix_raises():
    """An explicit strategy request must never silently run a different
    engine: the removed kernel's name raises, naming the removal."""
    from gpu_radix_sort_tpu.ops.radix_sort import sort_full

    with pytest.raises(ValueError, match="removed"):
        sort_full(np.arange(1024, dtype=np.uint32), strategy="pallas_radix")


def test_zero_length_partref_reads_empty():
    """nbyte=0 at start=0 must NOT hit the backends' end<=0 (= whole part)
    convention."""
    fac = MemArrayFactory()
    arr = fac.create("z", create_shape([16]))
    arr.write_part(0, b"0123456789abcdef")
    ref = PartRef(arr, 0, 0, 0)
    with ref.reader() as r:
        assert r.read() == b""


def test_shared_registry_factories_share_lock():
    """Two factories over ONE registry dict must synchronize: concurrent
    create of the same name yields exactly one winner and one
    FileExistsError, never a silent overwrite."""
    reg: dict = {}
    f1, f2 = MemArrayFactory(reg), MemArrayFactory(reg)
    assert f1._lock is f2._lock
    results = []

    def create(fac):
        try:
            fac.create("same", create_shape([8]))
            results.append("ok")
        except FileExistsError:
            results.append("exists")

    ts = [threading.Thread(target=create, args=(f,)) for f in (f1, f2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sorted(results) == ["exists", "ok"]
    assert f2.open("same") is f1.open("same")


def test_native_histogram_rejects_bad_range():
    from gpu_radix_sort_tpu.utils import native

    for off, w in ((30, 8), (32, 1), (0, 33), (0, 0)):
        with pytest.raises(ValueError):
            native.histogram(np.arange(10, dtype=np.uint32), off, w)


def test_native_cpu_partial_rejects_wrapping_offset():
    from gpu_radix_sort_tpu.utils import native

    if native._load() is None:
        pytest.skip("native lib unavailable")
    with pytest.raises(ValueError):
        # uint32 wrap: 0xFFFFFFFE + 4 == 2 passes a naive offset+width check
        native.cpu_partial(np.arange(8, dtype=np.uint32), 0xFFFFFFFE, 4)


def test_chunked_device_get_limit():
    import jax.numpy as jnp

    from gpu_radix_sort_tpu.utils.transfer import chunked_device_get

    x = jnp.arange(1 << 20, dtype=jnp.uint32)
    got = chunked_device_get(x, limit=1000, chunk_bytes=1 << 12)
    np.testing.assert_array_equal(got, np.arange(1000, dtype=np.uint32))
    # limit on a non-chunked (small) array
    got2 = chunked_device_get(jnp.arange(10, dtype=jnp.uint32), limit=3)
    np.testing.assert_array_equal(got2, np.arange(3, dtype=np.uint32))


def test_cli_storage_env_precedence(tmp_path, monkeypatch):
    """Unset CLI flags must not clobber GRS_* env (explicit > env >
    default)."""
    from gpu_radix_sort_tpu.utils.config import SortConfig

    monkeypatch.setenv("GRS_BACKEND", "file")
    monkeypatch.setenv("GRS_MOUNT", str(tmp_path))
    monkeypatch.setenv("GRS_NWORKER", "3")
    cfg = SortConfig.from_env().validate()
    assert cfg.backend == "file"
    assert cfg.mount == str(tmp_path)
    assert cfg.nworker == 3
    # explicit override still wins
    cfg2 = SortConfig.from_env(nworker=5).validate()
    assert cfg2.nworker == 5 and cfg2.backend == "file"


def test_distributed_width_32_rejected():
    import jax

    from gpu_radix_sort_tpu.parallel.distributed import build_distributed_sort
    from gpu_radix_sort_tpu.parallel.mesh import key_mesh

    mesh = key_mesh(jax.devices("cpu"))
    with pytest.raises(ValueError):
        build_distributed_sort(mesh, 1024, width=32)


def test_sample_pipeline_accepts_auto_exchange():
    """exchange='auto' is sort_distributed's documented default; sweeping
    algorithms with a common exchange='auto' must not raise."""
    from gpu_radix_sort_tpu.models.pipelines import DistributedSortPipeline

    fn, (example,) = DistributedSortPipeline(
        n_local=1 << 10, algorithm="sample", exchange="auto"
    ).build()
    shards, counts, overflow = fn(example)
    assert int(overflow) == 0
    import jax

    nchips = len(jax.devices())
    shards = np.asarray(shards).reshape(nchips, -1)
    counts = np.asarray(counts).reshape(-1)
    out = np.concatenate([shards[i, : counts[i]] for i in range(nchips)])
    np.testing.assert_array_equal(out, np.sort(np.asarray(example)))
