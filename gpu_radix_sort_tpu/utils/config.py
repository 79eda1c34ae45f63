"""Framework configuration.

The reference has no config system — behavior is spread across compile-time
macros (MAX_BLOCK_SZ, sort.cu:5), Go constants (nworker=2, distrib.go:107),
a settable global (SetWidth, distrib.go:14-18), env vars (RADIXBENCH_ROOTPATH,
OL_SHARED_VOLUME, CUDA_VISIBLE_DEVICES) and commented-out code blocks
(f.py:198-201, benchmark.go:139-156).  SURVEY.md §5 calls for replacing all
of that with one explicit config object + CLI; this is it.

Precedence: explicit constructor args > environment (GRS_*) > defaults.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass


def _env(name: str, default, cast):
    raw = os.environ.get(f"GRS_{name}")
    if raw is None:
        return default
    try:
        return cast(raw)
    except ValueError as e:
        raise ValueError(f"bad GRS_{name}={raw!r}: {e}") from e


@dataclass
class SortConfig:
    """Everything tunable about a sort run, in one place."""

    # Digit width per distributed round (reference: SetWidth, distrib.go:14).
    width: int = 8
    # Storage-plane worker count (reference hard-codes 2, distrib.go:107).
    nworker: int = 2
    # Single-chip kernel strategy: auto | xla.
    strategy: str = "auto"
    # Mesh-path bucket exchange: auto | alltoall | gather.
    exchange: str = "auto"
    # All-to-all per-peer slot headroom over the even split.
    capacity_factor: float = 1.25
    # Storage backend for the storage-mediated path: mem | file | device.
    backend: str = "mem"
    # File-backend root; the subprocess-worker rendezvous
    # (reference: OL_SHARED_VOLUME, benchmark.go:79).
    mount: str | None = None
    # Worker kind for the storage-mediated path: local | subprocess | pool.
    # "pool" reuses persistent worker processes across rounds (warm jit
    # caches); "subprocess" spawns per invocation (the reference's model).
    worker: str = "local"
    # Per-round persistence (checkpoint/resume); None disables.
    checkpoint_dir: str | None = None
    # jax.profiler trace output dir; None disables.
    trace_dir: str | None = None

    @classmethod
    def from_env(cls, **overrides) -> "SortConfig":
        cfg = cls(
            width=_env("WIDTH", cls.width, int),
            nworker=_env("NWORKER", cls.nworker, int),
            strategy=_env("STRATEGY", cls.strategy, str),
            exchange=_env("EXCHANGE", cls.exchange, str),
            capacity_factor=_env("CAPACITY_FACTOR", cls.capacity_factor, float),
            backend=_env("BACKEND", cls.backend, str),
            mount=_env("MOUNT", cls.mount, str),
            worker=_env("WORKER", cls.worker, str),
            checkpoint_dir=_env("CHECKPOINT_DIR", cls.checkpoint_dir, str),
            trace_dir=_env("TRACE_DIR", cls.trace_dir, str),
        )
        return dataclasses.replace(cfg, **overrides)

    def validate(self) -> "SortConfig":
        if self.width <= 0 or 32 % self.width:
            raise ValueError(f"width {self.width} must divide 32")
        if self.nworker < 1:
            raise ValueError(f"nworker must be >= 1, got {self.nworker}")
        from ..ops.radix_sort import check_strategy
        from ..parallel.distributed import check_exchange

        check_strategy(self.strategy)
        check_exchange(self.exchange)
        if self.backend not in ("mem", "file", "device"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.worker not in ("local", "subprocess", "pool"):
            raise ValueError(f"unknown worker {self.worker!r}")
        if self.worker in ("subprocess", "pool") and self.backend != "file":
            raise ValueError(
                f"{self.worker} workers require backend='file'"
            )
        if self.backend == "file" and not self.mount:
            raise ValueError("backend='file' requires mount")
        return self

    def make_factory(self):
        from ..data import (
            DeviceArrayFactory,
            FileArrayFactory,
            MemArrayFactory,
        )

        if self.backend == "mem":
            return MemArrayFactory()
        if self.backend == "device":
            return DeviceArrayFactory()
        return FileArrayFactory(self.mount)

    def make_worker(self):
        """A DistribWorker per the config.  For worker='pool' prefer
        :meth:`make_worker_pool` (caller-managed lifetime); this method
        returns a worker whose pool lives until process exit."""
        from ..parallel.serverless import make_subprocess_worker
        from ..parallel.storage_sort import make_local_worker

        if self.worker == "pool":
            return self.make_worker_pool().worker()
        if self.worker == "subprocess":
            return make_subprocess_worker(self.mount)
        return make_local_worker(
            None if self.strategy == "auto" else self.strategy
        )

    def make_worker_pool(self):
        from ..parallel.serverless import WorkerPool

        return WorkerPool(self.mount, size=self.nworker)
