"""Subprocess (serverless-style) worker suite.

Mirrors the reference's FaaS tests (benchmark/pkg/faas/): the wire-protocol
round-trip (inputs_test.go:14-59) and the same worker-parametric suites the
in-process worker passes (faas_test.go:14-48), instantiated with real
process boundaries — each worker is a spawned Python interpreter exchanging
data through the file backend (the reference's direct-subprocess "fake FaaS
provider" pattern, invoke.go:111-117).
"""

import json

import numpy as np
import pytest

import gpu_radix_sort_tpu.utils.checks as checks
from gpu_radix_sort_tpu.data import (
    FileArrayFactory,
    PartRef,
    create_shape,
)
from gpu_radix_sort_tpu.parallel import (
    BucketReader,
    ReadOrder,
    build_event,
    handle_event,
    invoke_subprocess,
    make_subprocess_worker,
    part_ref_to_wire,
    sort_distrib_from_raw,
    wire_to_part_ref,
)
from gpu_radix_sort_tpu.utils.keygen import Pcg32


@pytest.fixture
def mount(tmp_path):
    return str(tmp_path / "shared")


def test_wire_round_trip(mount):
    """PartRef -> wire -> PartRef preserves the reference field names and
    values (reference: TestFaasFilePartRef, inputs_test.go:14-59)."""
    factory = FileArrayFactory(mount)
    arr = factory.create("wire", create_shape([64]))
    arr.write_part(0, bytes(range(64)))
    arr.close()
    ref = PartRef(arr, 0, 8, 16)
    wire = part_ref_to_wire(ref)
    assert wire == {"arrayName": "wire", "partID": 0, "start": 8, "nbyte": 16}
    # survives JSON
    wire2 = json.loads(json.dumps(wire))
    cache = {}
    back = wire_to_part_ref(wire2, factory, cache)
    assert (back.arr.name, back.part_idx, back.start, back.nbyte) == (
        "wire", 0, 8, 16,
    )
    with back.reader() as r:
        assert r.read() == bytes(range(8, 24))
    # open-array cache: same name resolves to the same object
    again = wire_to_part_ref(wire2, factory, cache)
    assert again.arr is back.arr


def test_handle_event_in_process(mount):
    """Handler body validated without a process boundary."""
    factory = FileArrayFactory(mount)
    keys = Pcg32().fill(1021)
    arr = factory.create("in", create_shape([keys.size * 4]))
    arr.write_part(0, keys.tobytes())
    arr.close()
    event = build_event([PartRef(arr, 0, 0, keys.size * 4)], 0, 8, "out")
    out = handle_event(event, factory)
    got = np.frombuffer(out.read_all(), dtype=np.uint32)
    assert checks.check_partial(got, keys, 0, 8)
    assert out.get_shape().npart == 256


def test_handle_event_rejects_bad_arrtype(mount):
    with pytest.raises(ValueError, match="arrType"):
        handle_event({"arrType": "mem", "input": [], "offset": 0,
                      "width": 8, "output": "x"}, FileArrayFactory(mount))


def test_invoke_subprocess_one_round(mount):
    """One real worker process sorts one shard (reference:
    DistribWorkerTest with the FaaS worker, faas_test.go:14-30)."""
    factory = FileArrayFactory(mount)
    keys = Pcg32().fill(1021)
    arr = factory.create("in", create_shape([keys.size * 4]))
    arr.write_part(0, keys.tobytes())
    arr.close()

    worker = make_subprocess_worker(mount)
    out = worker([PartRef(arr, 0, 0, keys.size * 4)], 8, 8, "sub_out", factory)
    got = np.frombuffer(out.read_all(), dtype=np.uint32)
    assert checks.check_partial(got, keys, 8, 8)
    np.testing.assert_array_equal(
        np.array(out.get_shape().lens) // 4,
        checks.true_bucket_counts(keys, 8, 8),
    )


def test_invoke_subprocess_error_in_band(mount):
    """Worker failures come back as {success: False, err} (reference:
    f.py:58-69 / invoke.go:160-170), not as a dead process."""
    result = invoke_subprocess(
        {"offset": 0, "width": 8, "arrType": "file",
         "input": [{"arrayName": "missing", "partID": 0,
                    "start": 0, "nbyte": 4}],
         "output": "nope"},
        mount,
    )
    assert result["success"] is False
    assert "missing" in result["err"]


def test_sort_distrib_subprocess_end_to_end(mount):
    """Full distributed sort with every round's workers in fresh processes
    (reference: SortDistribTest x FaaS worker, faas_test.go:32-48).
    width=16 keeps it to 2 rounds x 2 workers = 4 process spawns."""
    factory = FileArrayFactory(mount)
    keys = Pcg32().fill(1111)
    worker = make_subprocess_worker(mount)
    got = sort_distrib_from_raw(
        keys, "sube2e", factory, worker, width=16, nworker=2
    )
    assert checks.check_sort_full(got, keys)


def test_subprocess_profiling(mount, tmp_path):
    """GRS_PROFILE_DIR makes each invocation dump cProfile output
    (reference: f.py:24-36 per-invocation profiles)."""
    import os

    factory = FileArrayFactory(mount)
    keys = Pcg32().fill(256)
    arr = factory.create("in", create_shape([keys.size * 4]))
    arr.write_part(0, keys.tobytes())
    arr.close()
    prof_dir = str(tmp_path / "prof")
    worker = make_subprocess_worker(mount, profile_dir=prof_dir)
    worker([PartRef(arr, 0, 0, keys.size * 4)], 0, 8, "prof_out", factory)
    files = os.listdir(prof_dir)
    assert any(f.endswith(".prof") for f in files)
    assert any(f.endswith(".txt") for f in files)


def test_subprocess_worker_requires_file_factory(mount):
    from gpu_radix_sort_tpu.data import MemArrayFactory

    worker = make_subprocess_worker(mount)
    with pytest.raises(TypeError, match="file backend"):
        worker([], 0, 8, "x", MemArrayFactory())


# ---------------------------------------------------------------------------
# Persistent worker pool
# ---------------------------------------------------------------------------

def test_worker_pool_end_to_end(mount):
    """Full distributed sort with a pool of 2 persistent worker processes:
    8 rounds of work over 2 spawns (vs 8 spawns per-invocation)."""
    from gpu_radix_sort_tpu.parallel import WorkerPool

    factory = FileArrayFactory(mount)
    keys = Pcg32().fill(1111)
    with WorkerPool(mount, size=2) as pool:
        got = sort_distrib_from_raw(
            keys, "poole2e", factory, pool.worker(), width=8, nworker=2
        )
        assert checks.check_sort_full(got, keys)
        # reuse: a second sort through the SAME processes (warm jit caches)
        keys2 = Pcg32().fill(777)
        got2 = sort_distrib_from_raw(
            keys2, "poole2e2", factory, pool.worker(), width=16, nworker=2
        )
        assert checks.check_sort_full(got2, keys2)
        assert len(pool._procs) == 2  # no respawns needed


def test_worker_pool_error_in_band_and_survives(mount):
    from gpu_radix_sort_tpu.parallel import WorkerPool

    with WorkerPool(mount, size=1) as pool:
        bad = {"offset": 0, "width": 8, "arrType": "file",
               "input": [{"arrayName": "missing", "partID": 0,
                          "start": 0, "nbyte": 4}],
               "output": "nope"}
        result = pool.invoke(bad)
        assert result["success"] is False and "missing" in result["err"]
        # the same worker still serves good events afterwards
        factory = FileArrayFactory(mount)
        keys = Pcg32().fill(256)
        arr = factory.create("pin", create_shape([keys.size * 4]))
        arr.write_part(0, keys.tobytes())
        arr.close()
        out = pool.worker()(
            [PartRef(arr, 0, 0, keys.size * 4)], 0, 8, "pout", factory
        )
        got = np.frombuffer(out.read_all(), dtype=np.uint32)
        assert checks.check_partial(got, keys, 0, 8)


def test_worker_pool_respawns_dead_worker(mount):
    from gpu_radix_sort_tpu.parallel import WorkerPool

    with WorkerPool(mount, size=1) as pool:
        proc = pool._procs[0]
        proc.kill()
        proc.wait()
        result = pool.invoke({"offset": 0, "width": 8, "arrType": "file",
                              "input": [], "output": "resp"})
        # served by a fresh worker (empty input -> empty output array)
        assert result["success"] is True
        assert pool._procs[0] is not proc


def test_worker_pool_recovers_capacity_after_spawn_failure(mount, monkeypatch):
    """A failed respawn must return an empty slot to the queue (never a dead
    handle): the next invoke retries the spawn and succeeds."""
    from gpu_radix_sort_tpu.parallel import WorkerPool

    with WorkerPool(mount, size=1) as pool:
        proc = pool._procs[0]
        proc.kill()
        proc.wait()
        # force the respawn attempt to fail once
        real_spawn = pool._spawn
        calls = {"n": 0}

        def flaky_spawn(card):
            if calls["n"] == 0:
                calls["n"] += 1
                raise RuntimeError("injected spawn failure")
            return real_spawn(card)

        monkeypatch.setattr(pool, "_spawn", flaky_spawn)
        with pytest.raises(RuntimeError, match="injected spawn failure"):
            pool.invoke({"offset": 0, "width": 8, "arrType": "file",
                         "input": [], "output": "x1"})
        # pool capacity conserved: the slot is back and usable
        result = pool.invoke({"offset": 0, "width": 8, "arrType": "file",
                              "input": [], "output": "x2"})
        assert result["success"] is True


def test_worker_pool_closed_raises(mount):
    from gpu_radix_sort_tpu.parallel import WorkerPool

    pool = WorkerPool(mount, size=1)
    pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.invoke({"offset": 0, "width": 8, "arrType": "file",
                     "input": [], "output": "x"})
