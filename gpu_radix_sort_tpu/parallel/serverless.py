"""Out-of-process (serverless-style) distributed workers.

Capability mirror of the reference's FaaS layer (benchmark/pkg/faas/ +
faasTest/): the round loop stays backend-blind — a :class:`DistribWorker`
that happens to serialize its PartRefs to JSON, spawn a worker process, and
re-open the worker's output array by name.

Wire protocol (field names kept identical to the reference's JSON structs,
benchmark/pkg/faas/inputs.go:13-28, so the formats stay comparable):

  event  = {"offset": int, "width": int, "arrType": "file",
            "input":  [{"arrayName": str, "partID": int,
                        "start": int, "nbyte": int}, ...],
            "output": str}
  result = {"success": bool, "err": str}

Invocation is JSON over stdin/stdout of a spawned Python interpreter running
:mod:`gpu_radix_sort_tpu.parallel.worker_main` — the reference's
"direct invoke" path (invoke.go:118-171), which it uses in practice in
place of a real FaaS provider (invoke.go:196-200).  The shared-filesystem
rendezvous (the reference's OL_SHARED_VOLUME, benchmark.go:79) is the
``GRS_WORKER_MOUNT`` env var pointing at a FileArrayFactory root.

Device ownership: a worker process never opens a card that another process
holds (a JAX process reserves most of a card's memory when it first uses
it).  Workers run on the CPU by default (``platform="cpu"``: the child gets
``JAX_PLATFORMS=cpu`` and no visible CUDA device).  ``platform="gpu"`` pins
each worker to one card with ``CUDA_VISIBLE_DEVICES``, as the reference
pinned its workers (invoke.go:138-139); the caller names the card, and a
pool names one distinct card per worker.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Sequence

from ..data.file import FileArrayFactory
from ..data.interface import ArrayFactory, DistribArray, PartRef

MOUNT_ENV = "GRS_WORKER_MOUNT"
PLATFORMS = ("cpu", "gpu")
PROFILE_ENV = "GRS_PROFILE_DIR"
WORKER_MODULE = "gpu_radix_sort_tpu.parallel.worker_main"


def part_ref_to_wire(ref: PartRef) -> dict:
    """PartRef -> wire dict (reference: FilePartRefToFaas, inputs.go:36-44)."""
    return {
        "arrayName": ref.arr.name,
        "partID": ref.part_idx,
        "start": ref.start,
        "nbyte": ref.nbyte,
    }


def wire_to_part_ref(
    d: dict, factory: ArrayFactory, cache: dict[str, DistribArray]
) -> PartRef:
    """Wire dict -> PartRef, with an open-array cache (reference:
    LoadFaasFilePartRef, inputs.go:46-63 / pylibsort getPartRefs'
    open-array cache, data.py:280-286)."""
    name = d["arrayName"]
    arr = cache.get(name)
    if arr is None:
        arr = factory.open(name)
        cache[name] = arr
    return PartRef(arr, d["partID"], d["start"], d["nbyte"])


def build_event(
    refs: Sequence[PartRef],
    offset: int,
    width: int,
    out_name: str,
    row_bytes: int = 4,
    key_bits: int = 32,
) -> dict:
    event = {
        "offset": offset,
        "width": width,
        "arrType": "file",
        "input": [part_ref_to_wire(r) for r in refs],
        "output": out_name,
    }
    # kv-row extension: the reference wire format is byte-blind u32 keys
    # (inputs.go:13-28); fixed-width rows add one field, omitted for
    # keys-only events so those stay byte-identical to the reference's.
    if row_bytes != 4:
        event["rowBytes"] = row_bytes
    # 64-bit key extension (storage-plane u64, beyond libsort.h:19's u32):
    # offset then addresses bits of the 8-byte order-encoded leading word.
    if key_bits != 32:
        event["keyBits"] = key_bits
    return event


def handle_event(event: dict, factory: ArrayFactory) -> DistribArray:
    """Worker-side handler body (reference: f(event), faasTest/f.py:45-69):
    parse refs -> gather -> partial sort -> bucket-partitioned output."""
    from .storage_sort import local_distrib_worker, local_distrib_worker_kv

    if event.get("arrType", "file") != "file":
        raise ValueError(f"unsupported arrType {event.get('arrType')!r}")
    cache: dict[str, DistribArray] = {}
    refs = [wire_to_part_ref(d, factory, cache) for d in event["input"]]
    row_bytes = int(event.get("rowBytes", 4))
    key_bits = int(event.get("keyBits", 32))
    if row_bytes != 4 or key_bits != 32:
        return local_distrib_worker_kv(
            refs, event["offset"], event["width"], event["output"], factory,
            row_bytes=row_bytes, key_bits=key_bits,
        )
    return local_distrib_worker(
        refs, event["offset"], event["width"], event["output"], factory
    )


def invoke_subprocess(
    event: dict,
    mount: str,
    *,
    platform: str = "cpu",
    gpu: int | None = None,
    profile_dir: str | None = None,
    timeout_s: float = 600.0,
) -> dict:
    """Spawn a worker process, deliver the event on stdin, parse the result
    JSON from stdout (reference: InvokeFaasDirect, invoke.go:118-171).
    The worker runs on the CPU unless ``platform="gpu"``, which pins it to
    card ``gpu``."""
    env = _worker_env(mount, platform, profile_dir, gpu)
    proc = subprocess.run(
        [sys.executable, "-m", WORKER_MODULE],
        input=json.dumps(event).encode(),
        capture_output=True,
        env=env,
        timeout=timeout_s,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"worker process failed (rc={proc.returncode}): "
            f"{proc.stderr.decode(errors='replace')[-2000:]}"
        )
    try:
        return json.loads(proc.stdout.decode())
    except json.JSONDecodeError as e:
        raise RuntimeError(
            f"worker produced invalid response: {proc.stdout[-500:]!r}"
        ) from e


def _worker_env(
    mount: str, platform: str, profile_dir: str | None,
    gpu: int | None = None,
) -> dict:
    """The worker's environment: CPU workers see no card at all; a GPU
    worker sees exactly card ``gpu``."""
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got {platform!r}")
    if (platform == "gpu") != (gpu is not None):
        raise ValueError(
            "a GPU worker needs the index of the one card it may use "
            "(gpu=...); a CPU worker takes none"
        )
    env = dict(os.environ)
    env[MOUNT_ENV] = mount
    if platform == "gpu":
        env["JAX_PLATFORMS"] = "cuda"
        env["CUDA_VISIBLE_DEVICES"] = str(int(gpu))
    else:
        env["JAX_PLATFORMS"] = "cpu"
        env["CUDA_VISIBLE_DEVICES"] = ""
    if profile_dir is not None:
        env[PROFILE_ENV] = profile_dir
    return env


def _adapt_worker(invoke_fn, row_bytes: int = 4, key_bits: int = 32):
    """Wrap an event-invoking callable into a DistribWorker: serialize
    refs, invoke, re-open the committed output array by name (reference:
    InitFaasWorker, invoke.go:174-212)."""

    def worker(
        in_refs: Sequence[PartRef],
        offset: int,
        width: int,
        out_name: str,
        factory: ArrayFactory,
    ) -> DistribArray:
        if not isinstance(factory, FileArrayFactory):
            raise TypeError(
                "subprocess workers exchange data via the file backend; got "
                f"{type(factory).__name__}"
            )
        result = invoke_fn(
            build_event(in_refs, offset, width, out_name, row_bytes, key_bits)
        )
        if not result.get("success"):
            raise RuntimeError(f"worker error: {result.get('err')}")
        return factory.open(out_name)

    return worker


class WorkerPool:
    """A pool of persistent worker processes serving events over pipes.

    The reference's FaaS model spawns a fresh interpreter per invocation
    (invoke.go:118-171) — every round pays import + compile.  A pool keeps
    workers alive across rounds, so their jit caches stay warm (shard
    shapes are pow2-padded by the local worker, making cache hits the
    common case).  Thread-safe: concurrent invokes check workers out of a
    free queue, matching the round loop's ThreadPoolExecutor.

    Use as a context manager; :meth:`worker` adapts the pool into a
    :class:`DistribWorker` for ``sort_distrib_from_arr``.

    Workers run on the CPU by default.  ``platform="gpu"`` takes ``gpus``,
    one distinct card index per worker, and pins each worker (and any
    replacement for it) to its own card.
    """

    def __init__(
        self,
        mount: str,
        size: int = 2,
        *,
        platform: str = "cpu",
        gpus: Sequence[int] | None = None,
        profile_dir: str | None = None,
        spawn_timeout_s: float = 120.0,
    ):
        import queue

        if platform == "gpu":
            gpus = [int(g) for g in (gpus or ())]
            if len(gpus) != size or len(set(gpus)) != size:
                raise ValueError(
                    f"a GPU pool of {size} workers needs {size} distinct "
                    f"card indices, got gpus={gpus}"
                )
        elif gpus is not None:
            raise ValueError("gpus is only for platform='gpu'")
        self._mount = mount
        self._platform = platform
        self._profile_dir = profile_dir
        self._spawn_timeout_s = spawn_timeout_s
        self._closed = False
        self._procs: list[subprocess.Popen] = []
        # Queue of SLOTS (card, proc): card is the slot's GPU index (None on
        # the CPU), proc a live worker or None meaning "spawn on demand".
        # Failure paths return (card, None) to the queue, so the pool is
        # never poisoned with dead handles and keeps its capacity and cards.
        self._free: "queue.Queue[tuple]" = queue.Queue()
        for card in (gpus if platform == "gpu" else [None] * size):
            self._free.put((card, self._spawn(card)))

    def _reap(self, proc: subprocess.Popen) -> None:
        if proc in self._procs:
            self._procs.remove(proc)
        if proc.poll() is None:
            proc.kill()
        proc.wait()

    def _spawn(self, card: int | None) -> subprocess.Popen:
        import select
        import time as _time

        proc = subprocess.Popen(
            [sys.executable, "-m", WORKER_MODULE, "--serve"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=_worker_env(
                self._mount, self._platform, self._profile_dir, card
            ),
            text=True,
        )
        try:
            deadline = _time.monotonic() + self._spawn_timeout_s
            line = ""
            while _time.monotonic() < deadline:
                r, _, _ = select.select([proc.stdout], [], [], 1.0)
                if r:
                    line = proc.stdout.readline()
                    break
                if proc.poll() is not None:
                    break
            try:
                ready = bool(line) and json.loads(line).get("ready")
            except json.JSONDecodeError:
                ready = False
            if not ready:
                raise RuntimeError(
                    f"worker failed to start (rc={proc.poll()}): {line!r}"
                )
        except BaseException:
            self._reap(proc)  # never leak a half-started child
            raise
        self._procs.append(proc)
        return proc

    def invoke(self, event: dict) -> dict:
        if self._closed:
            raise RuntimeError("WorkerPool is closed")
        card, proc = self._free.get()
        try:
            if proc is not None and proc.poll() is not None:
                self._reap(proc)  # died since last use
                proc = None
            if proc is None:
                proc = self._spawn(card)
            try:
                proc.stdin.write(json.dumps(event) + "\n")
                proc.stdin.flush()
            except (BrokenPipeError, OSError) as e:
                # died between the liveness check and the write: reap (else
                # the Popen lingers unreaped in _procs) and surface the
                # same died-mid-event error as the empty-readline path.
                rc = proc.poll()
                self._reap(proc)
                proc = None
                raise RuntimeError(
                    f"worker process died mid-event (rc={rc})"
                ) from e
            line = proc.stdout.readline()
            if not line:
                rc = proc.poll()
                self._reap(proc)
                proc = None
                raise RuntimeError(f"worker process died mid-event (rc={rc})")
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                self._reap(proc)  # stdout desynced: recycle the worker
                proc = None
                raise RuntimeError(
                    f"worker produced invalid response: {line!r}"
                )
        finally:
            healthy = (
                proc is not None
                and proc.poll() is None
                and proc in self._procs
            )
            self._free.put((card, proc if healthy else None))

    def worker(self, row_bytes: int = 4, key_bits: int = 32):
        """Adapt the pool into a DistribWorker (kv rows via row_bytes;
        64-bit keys via key_bits)."""
        return _adapt_worker(self.invoke, row_bytes, key_bits)

    def close(self) -> None:
        self._closed = True
        for proc in list(self._procs):
            if proc.poll() is None:
                proc.stdin.close()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        self._procs.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def make_subprocess_worker(
    mount: str,
    *,
    platform: str = "cpu",
    gpu: int | None = None,
    profile_dir: str | None = None,
    row_bytes: int = 4,
    key_bits: int = 32,
):
    """Adapt subprocess invocation into a DistribWorker (reference:
    InitFaasWorker, invoke.go:174-212): serialize refs, invoke, re-open the
    worker's committed output array by name.  Each invocation runs on the
    CPU unless ``platform="gpu"``, which pins it to card ``gpu``."""
    _worker_env(mount, platform, None, gpu)  # reject a bad pairing now

    return _adapt_worker(
        lambda event: invoke_subprocess(
            event, mount, platform=platform, gpu=gpu,
            profile_dir=profile_dir,
        ),
        row_bytes,
        key_bits,
    )
