"""Benchmark harness: timed runs of every execution path, with stats.

Reference analog: benchmark/pkg/benchmark (RunBenchmarks / BenchFaasAll /
ReportStats, benchmark.go + util.go) and the C++ localTest benches
(benchmarks.cpp).  Produces structured records (JSON-able dicts) rather than
printf: warmup compile excluded, every timed call ended by
``block_until_ready``, median over reps.

Three tiers mirror the reference's profiling stack (SURVEY.md §5):
  * per-op device timing here (nvprof analog),
  * optional jax.profiler traces via ``trace_dir`` (cudaProfilerStart/Stop
    analog, invokers.cu:73-85),
  * per-phase SortStats from the storage path (cProfile-per-worker analog).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import asdict, dataclass, field

import numpy as np

from ..utils.config import SortConfig
from ..utils.keygen import Pcg32, generate_payloads, generate_zipf_keys
from ..utils.timers import SortStats


@dataclass
class BenchRecord:
    name: str
    n: int
    reps: int
    median_s: float
    mean_s: float
    stdev_s: float
    rate_per_s: float
    unit: str = "keys/s"
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)

    def line(self) -> str:
        return (
            f"{self.name:<34} n={self.n:>12,} median={self.median_s * 1e3:9.2f}ms "
            f"rate={self.rate_per_s / 1e6:9.1f}M {self.unit} "
            f"(±{self.stdev_s * 1e3:.2f}ms, {self.reps} reps)"
        )


def device_time(fn, args, *, reps: int = 5, warmup: int = 1):
    """(median_s, mean_s, stdev_s, last_out) of fn(*args) on device."""
    import jax

    out = None
    for _ in range(max(warmup, 1)):
        out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return (
        statistics.median(times),
        statistics.fmean(times),
        statistics.stdev(times) if len(times) > 1 else 0.0,
        out,
    )


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """jax.profiler region (the reference's region-scoped nvprof,
    invokers.cu:73-85 + profile.sh)."""
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield


def _record(name, n, reps, med, mean, sd, unit="keys/s", **extra) -> BenchRecord:
    return BenchRecord(
        name=name, n=n, reps=reps, median_s=med, mean_s=mean, stdev_s=sd,
        rate_per_s=n / med if med > 0 else 0.0, unit=unit, extra=extra,
    )


# ---------------------------------------------------------------------------
# Single-chip benches
# ---------------------------------------------------------------------------

def bench_full_sort(n: int, *, strategy=None, reps=5, trace_dir=None) -> BenchRecord:
    import jax

    from ..ops.radix_sort import sort_full

    keys = jax.device_put(Pcg32().fill(n))
    fn = jax.jit(lambda k: sort_full(k, strategy=strategy))
    with maybe_trace(trace_dir):
        med, mean, sd, _ = device_time(fn, (keys,), reps=reps)
    return _record("full_sort_u32", n, reps, med, mean, sd,
                   strategy=strategy or "auto")


def bench_full_sort_u64(n: int, *, reps=3) -> BenchRecord:
    """64-bit keys (hi/lo word lanes, ONE lexicographic 2-lane sort —
    ops/radix_sort.sort_full_u64's device compute) — the single-chip rate
    row for the beyond-reference u64 surface (host codec/split excluded
    like every other row)."""
    import jax
    import jax.numpy as jnp

    rng = __import__("numpy").random.default_rng(64)
    enc = rng.integers(0, 1 << 64, n, dtype="uint64")
    lo = jax.device_put(jnp.asarray((enc & 0xFFFFFFFF).astype("uint32")))
    hi = jax.device_put(jnp.asarray((enc >> 64 - 32).astype("uint32")))

    @jax.jit
    def fn(hi, lo):
        return jax.lax.sort((hi, lo), num_keys=2)

    med, mean, sd, _ = device_time(fn, (hi, lo), reps=reps)
    return _record("full_sort_u64", n, reps, med, mean, sd)


def bench_partial_sort(
    n: int, *, offset=0, width=8, strategy=None, reps=5, trace_dir=None,
    stable=True,
) -> BenchRecord:
    """``stable=False`` benches the reference-contract route (digit groups
    only, the contract the reference itself checks — utils/checks.py
    ``check_partial_groups``); its row carries a ``_refcontract`` suffix so
    the stable row stays the like-for-like LSD-grade comparison."""
    import jax

    from ..ops.radix_sort import sort_partial

    keys = jax.device_put(Pcg32().fill(n))
    fn = jax.jit(
        lambda k: sort_partial(k, offset, width, strategy=strategy,
                               stable=stable)
    )
    suffix = "" if stable else "_refcontract"
    with maybe_trace(trace_dir):
        med, mean, sd, _ = device_time(fn, (keys,), reps=reps)
    return _record(f"partial_sort_u32_w{width}{suffix}", n, reps, med, mean,
                   sd, offset=offset, width=width)


def bench_key_value_sort(
    n: int, *, payload_bytes=8, reps=3, trace_dir=None
) -> BenchRecord:
    import jax

    from ..ops.radix_sort import sort_key_value

    keys = jax.device_put(Pcg32().fill(n))
    values = jax.device_put(generate_payloads(n, payload_bytes=payload_bytes))
    fn = jax.jit(sort_key_value)
    with maybe_trace(trace_dir):
        med, mean, sd, _ = device_time(fn, (keys, values), reps=reps)
    return _record(f"kv_sort_u32_p{payload_bytes}B", n, reps, med, mean, sd,
                   unit="rows/s", payload_bytes=payload_bytes)


def bench_kv_digit_sort(
    n: int, *, offset=8, width=4, strategy=None, reps=3, trace_dir=None
) -> BenchRecord:
    """Single-u32-lane kv digit sort."""
    import jax
    import numpy as np

    from ..ops.radix_sort import sort_key_value_by_digits

    keys = jax.device_put(Pcg32().fill(n))
    vals = jax.device_put(np.arange(n, dtype=np.uint32))
    fn = jax.jit(
        lambda k, v: sort_key_value_by_digits(
            k, v, offset, width, strategy=strategy
        )
    )
    with maybe_trace(trace_dir):
        med, mean, sd, _ = device_time(fn, (keys, vals), reps=reps)
    return _record(f"kv_digit_sort_w{width}", n, reps, med, mean, sd,
                   unit="pairs/s", offset=offset, width=width,
                   strategy=strategy or "auto")


def bench_keygen(n: int, *, reps=5) -> BenchRecord:
    gen = Pcg32()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        gen.fill(n)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return _record("keygen_pcg32", n, reps, med, statistics.fmean(times),
                   statistics.stdev(times) if reps > 1 else 0.0)


# ---------------------------------------------------------------------------
# Mesh-path benches (device collectives)
# ---------------------------------------------------------------------------

def bench_mesh_lsd(
    n_local: int, *, width=8, exchange="alltoall", reps=3, mesh=None,
    trace_dir=None,
) -> BenchRecord:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.distributed import build_distributed_sort
    from ..parallel.mesh import KEY_AXIS, key_mesh

    mesh = mesh or key_mesh()
    nchips = mesh.shape[KEY_AXIS]
    n = n_local * nchips
    keys = jax.device_put(Pcg32().fill(n), NamedSharding(mesh, P(KEY_AXIS)))
    fn = build_distributed_sort(mesh, n_local, width=width, exchange=exchange)
    with maybe_trace(trace_dir):
        med, mean, sd, out = device_time(fn, (keys,), reps=reps)
    overflow = int(out[1])
    return _record(f"mesh_lsd_w{width}_{exchange}", n, reps, med, mean, sd,
                   nchips=nchips, overflow=overflow)


def bench_mesh_sample(
    n_local: int, *, reps=3, mesh=None, capacity_factor=1.5, trace_dir=None
) -> BenchRecord:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import KEY_AXIS, key_mesh
    from ..parallel.sample_sort import build_sample_sort

    mesh = mesh or key_mesh()
    nchips = mesh.shape[KEY_AXIS]
    n = n_local * nchips
    keys = jax.device_put(Pcg32().fill(n), NamedSharding(mesh, P(KEY_AXIS)))
    fn, _cap = build_sample_sort(mesh, n_local, capacity_factor=capacity_factor)
    with maybe_trace(trace_dir):
        med, mean, sd, out = device_time(fn, (keys,), reps=reps)
    overflow = int(out[2])
    return _record("mesh_sample_sort", n, reps, med, mean, sd,
                   nchips=nchips, overflow=overflow)


def bench_mesh_sort64(
    n_local: int, *, reps=3, mesh=None, capacity_factor=1.5, trace_dir=None
) -> BenchRecord:
    """Distributed 64-bit keys-only sort: the single-pass (hi, lo)-lane
    PSRS (parallel/sample_sort.build_sample_sort_64)."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import KEY_AXIS, key_mesh
    from ..parallel.sample_sort import build_sample_sort_64

    mesh = mesh or key_mesh()
    nchips = mesh.shape[KEY_AXIS]
    n = n_local * nchips
    rng = np.random.default_rng(64)
    enc = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    sharding = NamedSharding(mesh, P(KEY_AXIS))
    hi = jax.device_put((enc >> np.uint64(32)).astype(np.uint32), sharding)
    lo = jax.device_put(
        (enc & np.uint64(0xFFFFFFFF)).astype(np.uint32), sharding
    )
    fn, _cap = build_sample_sort_64(
        mesh, n_local, capacity_factor=capacity_factor
    )
    with maybe_trace(trace_dir):
        med, mean, sd, out = device_time(fn, (hi, lo), reps=reps)
    overflow = int(out[3])
    return _record("mesh_sort64", n, reps, med, mean, sd,
                   nchips=nchips, overflow=overflow)


def bench_mesh_sort64_lsd(
    n_local: int, *, reps=3, mesh=None, capacity_factor=1.5
) -> BenchRecord:
    """The 64-bit LSD composition (sort_distributed_64 single_pass=False)
    measured as its two stable kv sample-sort passes, each device-timed and
    summed (the host restage between passes is excluded — both variants'
    staging edges are identical, so the sum isolates the mesh work).  The
    same-vintage A/B row next to bench_mesh_sort64's single-pass PSRS."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import KEY_AXIS, key_mesh
    from ..parallel.sample_sort import build_sample_sort_kv

    mesh = mesh or key_mesh()
    nchips = mesh.shape[KEY_AXIS]
    n = n_local * nchips
    rng = np.random.default_rng(64)
    enc = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    hi = (enc >> np.uint64(32)).astype(np.uint32)
    lo = (enc & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    sharding = NamedSharding(mesh, P(KEY_AXIS))
    fn, _cap = build_sample_sort_kv(
        mesh, n_local, 1, capacity_factor=capacity_factor
    )

    def compact(padded_k, padded_v, counts):
        pk = np.asarray(jax.device_get(padded_k)).reshape(nchips, -1)
        pv = np.asarray(jax.device_get(padded_v)).reshape(nchips, -1)
        c = np.asarray(jax.device_get(counts)).reshape(-1)
        k = np.concatenate([pk[i, : c[i]] for i in range(nchips)])
        v = np.concatenate([pv[i, : c[i]] for i in range(nchips)])
        return k, v

    # pass 1: stable by lo, carrying hi
    args1 = (jax.device_put(lo, sharding),
             jax.device_put(hi[:, None], sharding))
    med1, mean1, sd1, out1 = device_time(fn, args1, reps=reps)
    ovf = int(out1[3])
    if ovf:
        # an overflowed pass would silently clip in compact() and feed a
        # wrong-sized pass 2 — surface it like every host-facing path does
        raise AssertionError(
            f"mesh_sort64_lsd pass-1 exchange overflowed ({ovf} chips); "
            "raise capacity_factor"
        )
    slo, shi = compact(out1[0], out1[1][:, 0], out1[2])
    # pass 2: stable by hi, carrying lo (input = pass 1's true output)
    args2 = (jax.device_put(shi, sharding),
             jax.device_put(slo[:, None], sharding))
    med2, mean2, sd2, out2 = device_time(fn, args2, reps=reps)
    ovf += int(out2[3])
    return _record(
        "mesh_sort64_lsd", n, reps, med1 + med2, mean1 + mean2,
        (sd1**2 + sd2**2) ** 0.5, nchips=nchips, overflow=ovf,
    )


def bench_mesh_kv_sample(
    n_local: int, *, payload_bytes=64, reps=3, mesh=None,
    capacity_factor=1.5, trace_dir=None,
) -> BenchRecord:
    """Distributed stable key-value sort (BASELINE.json config 3 shape)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import KEY_AXIS, key_mesh
    from ..parallel.sample_sort import build_sample_sort_kv

    mesh = mesh or key_mesh()
    nchips = mesh.shape[KEY_AXIS]
    n = n_local * nchips
    W = payload_bytes // 4
    sharding = NamedSharding(mesh, P(KEY_AXIS))
    keys = jax.device_put(Pcg32().fill(n), sharding)
    vals = jax.device_put(
        generate_payloads(n, payload_bytes=payload_bytes)
        .view(np.uint32).reshape(n, W),
        sharding,
    )
    fn, _cap = build_sample_sort_kv(
        mesh, n_local, W, capacity_factor=capacity_factor
    )
    with maybe_trace(trace_dir):
        med, mean, sd, out = device_time(fn, (keys, vals), reps=reps)
    return _record(f"mesh_kv_sample_p{payload_bytes}B", n, reps, med, mean,
                   sd, unit="rows/s", nchips=nchips, overflow=int(out[3]))


def bench_hash_aggregate(
    n_local: int, *, op="count", zipf_alpha=1.2, reps=3, mesh=None,
    trace_dir=None,
) -> BenchRecord:
    """The skewed pipeline bench (BASELINE.json config 5): Zipf keys,
    distributed hash-partition + combine + sampled-splitter exchange +
    aggregate."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import KEY_AXIS, key_mesh
    from ..parallel.pipeline import build_hash_aggregate

    mesh = mesh or key_mesh()
    nchips = mesh.shape[KEY_AXIS]
    n = n_local * nchips
    keys = generate_zipf_keys(n, alpha=zipf_alpha, seed=9)
    vals = np.ones(n, dtype=np.float32)
    valid = np.ones(n, dtype=bool)
    sharding = NamedSharding(mesh, P(KEY_AXIS))
    dk = jax.device_put(keys, sharding)
    dv = jax.device_put(vals, sharding)
    dm = jax.device_put(valid, sharding)
    fn, _cap = build_hash_aggregate(mesh, n_local, op=op)
    with maybe_trace(trace_dir):
        med, mean, sd, out = device_time(fn, (dk, dv, dm), reps=reps)
    return _record(f"hash_aggregate_{op}_zipf", n, reps, med, mean, sd,
                   unit="rows/s", nchips=nchips, overflow=int(out[3]))


# ---------------------------------------------------------------------------
# Storage-path bench (wall clock incl. IO, per-phase stats)
# ---------------------------------------------------------------------------

def bench_storage_distrib(
    n: int, cfg: SortConfig, *, reps=1, warmup=True
) -> BenchRecord:
    from ..parallel.storage_sort import sort_distrib_from_raw
    from ..utils.checks import check_sort_full

    cfg.validate()
    keys = Pcg32().fill(n)
    # One worker (and for worker='pool' one pool, context-managed so its
    # processes don't outlive the bench) shared by warmup and every rep:
    # per-rep workers would pay cold jit compiles inside the timed region
    # and leak pool processes.
    with contextlib.ExitStack() as stack:
        if cfg.worker == "pool":
            worker = stack.enter_context(cfg.make_worker_pool()).worker()
        else:
            worker = cfg.make_worker()
        if warmup:
            # exclude one-time jit compiles (shard shapes are pow2-padded,
            # so a same-size run covers the cache) from the timed reps
            sort_distrib_from_raw(
                keys, "bench_warmup", cfg.make_factory(), worker,
                width=cfg.width, nworker=cfg.nworker,
            )
        times = []
        stats = SortStats()
        for rep in range(reps):
            factory = cfg.make_factory()
            t0 = time.perf_counter()
            got = sort_distrib_from_raw(
                keys, f"bench_r{rep}", factory, worker,
                width=cfg.width, nworker=cfg.nworker, stats=stats,
                checkpoint_dir=cfg.checkpoint_dir,
            )
            times.append(time.perf_counter() - t0)
            if not check_sort_full(got, keys):
                raise AssertionError(
                    "storage distrib sort produced wrong output"
                )
    med = statistics.median(times)
    return _record(
        f"storage_{cfg.backend}_{cfg.worker}_w{cfg.width}", n, reps, med,
        statistics.fmean(times),
        statistics.stdev(times) if reps > 1 else 0.0,
        phases=stats.report(), nworker=cfg.nworker,
    )


def bench_storage_kv(
    n: int, cfg: SortConfig, *, payload_bytes=64, reps=1, warmup=True
) -> BenchRecord:
    """KV rows through the storage plane (BASELINE config 3 shape at bench
    scale: uint32 key + fixed-width payload, multi-round partial sorts)."""
    from ..parallel.storage_sort import sort_distrib_from_raw_kv

    cfg.validate()
    keys = Pcg32().fill(n)
    payload = generate_payloads(n, payload_bytes=payload_bytes)
    stats = SortStats()

    def run(tag, rec=stats):
        return sort_distrib_from_raw_kv(
            keys, payload, tag, cfg.make_factory(),
            width=cfg.width, nworker=cfg.nworker, stats=rec,
        )

    if warmup:
        # cold-compile phases go to a throwaway recorder so the reported
        # phase stack decomposes only the timed reps (as bench_storage_distrib)
        run("kv_warmup", rec=SortStats())
    times = []
    for rep in range(reps):
        t0 = time.perf_counter()
        gk, gp = run(f"kv_r{rep}")
        times.append(time.perf_counter() - t0)
        order = np.argsort(keys, kind="stable")
        if not (
            np.array_equal(gk, keys[order])
            and np.array_equal(gp, payload[order])
        ):
            raise AssertionError("storage kv sort produced wrong output")
    med = statistics.median(times)
    return _record(
        f"storage_kv_{cfg.backend}_p{payload_bytes}B_w{cfg.width}", n, reps,
        med, statistics.fmean(times),
        statistics.stdev(times) if reps > 1 else 0.0,
        unit="rows/s", phases=stats.report(), nworker=cfg.nworker,
    )


def bench_storage_u64(
    n: int, cfg: SortConfig, *, reps=1, warmup=True
) -> BenchRecord:
    """64-bit keys through the storage plane (64/width LSD rounds over
    8-byte order-encoded rows, parallel/storage_sort.py) — the storage twin
    of bench_full_sort_u64, beyond the reference's u32-only surface
    (libsort.h:19)."""
    from ..parallel.storage_sort import sort_distrib_from_raw_u64

    cfg.validate()
    rng = np.random.default_rng(40)
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    stats = SortStats()

    def run(tag, rec=stats):
        return sort_distrib_from_raw_u64(
            keys, tag, cfg.make_factory(),
            width=cfg.width, nworker=cfg.nworker, stats=rec,
        )

    if warmup:
        run("u64_warmup", rec=SortStats())
    times = []
    for rep in range(reps):
        t0 = time.perf_counter()
        got = run(f"u64_r{rep}")
        times.append(time.perf_counter() - t0)
        if not np.array_equal(got, np.sort(keys)):
            raise AssertionError("storage u64 sort produced wrong output")
    med = statistics.median(times)
    return _record(
        f"storage_u64_{cfg.backend}_w{cfg.width}", n, reps, med,
        statistics.fmean(times),
        statistics.stdev(times) if reps > 1 else 0.0,
        phases=stats.report(), nworker=cfg.nworker,
    )


def run_scaling(
    n_local: int = 1 << 16, *, reps: int = 3
) -> list[BenchRecord]:
    """Weak-scaling sweep over mesh sizes (BASELINE.json config 4's
    measurement harness): fixed keys-per-chip, report aggregate rate and
    efficiency vs the 1-chip rate.  Meaningful numbers need real chips;
    on the virtual CPU mesh this validates the harness and shardings."""
    import jax

    devices = jax.devices()
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]
    from ..parallel.mesh import key_mesh

    records = []
    base_rate = None
    for nd in sizes:
        mesh = key_mesh(devices[:nd])
        rec = bench_mesh_sample(n_local, reps=reps, mesh=mesh)
        rec.name = f"scaling_sample_sort_{nd}chip"
        per_chip = rec.rate_per_s / nd
        if base_rate is None:
            base_rate = per_chip
        rec.extra["per_chip_rate"] = per_chip
        rec.extra["efficiency_vs_1chip"] = per_chip / base_rate
        records.append(rec)
    return records


# ---------------------------------------------------------------------------
# Suites
# ---------------------------------------------------------------------------

def run_benchmarks(
    suite: str = "quick", *, trace_dir: str | None = None
) -> list[BenchRecord]:
    """The RunBenchmarks analog (benchmark.go:126-180).  Sizes follow the
    device present: ``full`` needs a GPU and sorts the reference's workload
    scale, 256Mi keys per device (benchmarks.cpp:9-15); ``quick`` runs
    8Mi keys on a GPU and 1Mi on the CPU (for CI)."""
    import jax

    if suite == "scaling":
        return run_scaling()
    on_gpu = jax.devices()[0].platform == "gpu"
    if suite == "full":
        if not on_gpu:
            raise RuntimeError(
                "the full suite needs a GPU; JAX's first device is "
                f"{jax.devices()[0].platform}"
            )
        # the reference's standard workload size: 256Mi keys per device
        # (localTest/benchmarks.cpp:9-15) — size-for-size BASELINE.md rows
        n1 = 256 << 20
    else:
        n1 = (8 << 20) if on_gpu else (1 << 20)
    reps = 3
    n_local = max(n1 // max(len(jax.devices()), 1), 1 << 12)
    if suite == "full":
        # the mesh cells measure exchange overheads at the quick scale
        n_local = min(n_local, 8 << 20)

    records = [
        bench_keygen(n1),
        bench_full_sort(n1, reps=reps, trace_dir=trace_dir),
        bench_partial_sort(n1, width=4, reps=reps),
        bench_partial_sort(n1, width=8, reps=reps),
        bench_partial_sort(n1, width=16, reps=reps),
        bench_partial_sort(n1, width=8, reps=reps, stable=False),
        bench_partial_sort(n1, width=16, reps=reps, stable=False),
        bench_key_value_sort(n1 // 2, payload_bytes=8, reps=reps),
        bench_kv_digit_sort(n1, width=4, reps=reps),
        # 64B payloads: grouped lane-riding sorts (ops/radix_sort.py
        # _permute_lanes_grouped) — the wide-row regime of BASELINE config 3.
        # n1//16 rows keep the rows and the grouped-lane sort temporaries
        # well inside one card; the largest size that fits is not measured.
        bench_key_value_sort(n1 // 16, payload_bytes=64, reps=reps),
        bench_mesh_lsd(n_local, width=8, exchange="alltoall", reps=reps),
        bench_mesh_sample(n_local, reps=reps),
        bench_mesh_sort64(n_local // 2, reps=reps),
        bench_mesh_sort64_lsd(n_local // 2, reps=reps),
        bench_mesh_kv_sample(max(n_local // 4, 1 << 12), reps=reps),
        bench_hash_aggregate(n_local, op="count", reps=reps),
        bench_full_sort_u64(min(n1, 16 << 20), reps=reps),
        bench_storage_distrib(
            min(n1, 1 << 20), SortConfig(backend="mem"), reps=1
        ),
        bench_storage_distrib(
            min(n1, 8 << 20), SortConfig(backend="device", nworker=2),
            reps=1,
        ),
        bench_storage_kv(
            min(n1 // 8, 1 << 19), SortConfig(backend="mem"),
            payload_bytes=64, reps=1,
        ),
        bench_storage_u64(
            min(n1 // 8, 1 << 19), SortConfig(backend="mem"), reps=1
        ),
        # device backend -> the fused u64 loop (one program for all
        # 64/width rounds, storage_sort._sort_rounds_device_fused64)
        bench_storage_u64(
            min(n1, 4 << 20), SortConfig(backend="device", nworker=2),
            reps=1,
        ),
    ]
    return records


def report(records: list[BenchRecord], *, as_json=False) -> str:
    if as_json:
        import json

        return "\n".join(json.dumps(r.to_dict()) for r in records)
    return "\n".join(r.line() for r in records)
