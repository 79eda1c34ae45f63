"""Command-line entry point.

The reference's driver surface is scattered: a Go main that only prints
benchmark stats (benchmark/main.go), a C++ localTest binary with argv-coded
modes (localTest/main.cpp), and a Python worker whose mode is chosen by
editing __main__ (faasTest/f.py:198-201).  This CLI replaces all of it with
subcommands over one config object (utils/config.py):

  gen       generate the deterministic PCG32 key stream to a file
  sort      sort keys (single chip / mesh / sample / storage paths)
  bench     run the benchmark suites, text or JSON output
  worker    serve one worker event from stdin (subprocess worker entry)
  selftest  end-to-end exactness checks across every path (f.py selfTest)

Run as ``python -m gpu_radix_sort_tpu.cli`` or ``python -m gpu_radix_sort_tpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _cmd_gen(args) -> int:
    from .utils.keygen import Pcg32

    keys = Pcg32().fill(args.n)
    keys.tofile(args.out)
    print(f"wrote {args.n} uint32 keys ({args.n * 4} bytes) to {args.out}")
    return 0


def _load_keys(args) -> np.ndarray:
    if args.infile:
        keys = np.fromfile(args.infile, dtype=np.uint32)
        if args.n is not None:
            keys = keys[: args.n]
        return keys
    from .utils.keygen import Pcg32

    return Pcg32().fill(args.n if args.n is not None else 1 << 20)


def _cmd_sort(args) -> int:
    import time

    from .utils.config import SortConfig

    keys = _load_keys(args)
    t0 = time.perf_counter()
    if args.mode == "single":
        import jax

        from .ops.radix_sort import sort_full

        got = np.asarray(
            jax.device_get(sort_full(jax.device_put(keys), strategy=args.strategy))
        )
    elif args.mode == "mesh":
        from .parallel.distributed import sort_distributed

        got = sort_distributed(
            keys, width=args.width if args.width is not None else 8,
            exchange=args.exchange,
        )
    elif args.mode == "sample":
        from .parallel.sample_sort import sort_distributed_sample

        got = sort_distributed_sample(keys)
    else:  # storage
        explicit = {
            k: v
            for k, v in dict(
                width=args.width,
                nworker=args.nworker,
                strategy=args.strategy,
                backend=args.backend,
                worker=args.worker,
                mount=args.mount,
                checkpoint_dir=args.checkpoint_dir,
            ).items()
            if v is not None  # unset flags must not clobber GRS_* env
        }
        cfg = SortConfig.from_env(**explicit).validate()
        from .parallel.storage_sort import sort_distrib_from_raw

        if cfg.worker != "local":
            print(f"{cfg.worker} workers: {cfg.nworker} processes on the "
                  "CPU (platform='cpu'); GPU workers are pinned one per card "
                  "through parallel.serverless", file=sys.stderr)

        got = sort_distrib_from_raw(
            keys, "cli", cfg.make_factory(), cfg.make_worker(),
            width=cfg.width, nworker=cfg.nworker,
            checkpoint_dir=cfg.checkpoint_dir,
        )
    dt = time.perf_counter() - t0
    rate = keys.size / dt if dt else 0.0
    print(
        f"sorted {keys.size:,} keys via {args.mode} in {dt:.3f}s "
        f"({rate / 1e6:.1f}M keys/s)",
        file=sys.stderr,
    )
    if args.verify:
        if np.array_equal(got, np.sort(keys)):
            print("verify: EXACT MATCH", file=sys.stderr)
        else:
            print("verify: MISMATCH", file=sys.stderr)
            return 1
    if args.out:
        got.tofile(args.out)
    return 0


def _cmd_bench(args) -> int:
    from .bench.harness import report, run_benchmarks

    records = run_benchmarks(args.suite, trace_dir=args.trace_dir)
    print(report(records, as_json=args.json))
    return 0


def _cmd_analyze(args) -> int:
    from .bench.analyze import main as analyze_main

    return analyze_main(args.files)


def _cmd_worker(_args) -> int:
    from .parallel.worker_main import main as worker_main

    return worker_main()


def _cmd_selftest(args) -> int:
    """One-round + end-to-end exactness across paths (reference: f.py
    selfTest, f.py:71-144 — generate, run, verify)."""
    import tempfile

    import jax

    from .ops.radix_sort import sort_full, sort_partial
    from .parallel.distributed import sort_distributed
    from .parallel.sample_sort import sort_distributed_sample
    from .parallel.serverless import make_subprocess_worker
    from .parallel.storage_sort import local_distrib_worker, sort_distrib_from_raw
    from .data.file import FileArrayFactory
    from .data.mem import MemArrayFactory
    from .utils.checks import boundaries_oracle, check_partial, check_sort_full
    from .utils.keygen import Pcg32

    n = args.n
    keys = Pcg32().fill(n)
    failures = []

    def check(name, ok):
        print(f"  {'PASS' if ok else 'FAIL'}  {name}")
        if not ok:
            failures.append(name)

    got = np.asarray(jax.device_get(sort_full(jax.device_put(keys))))
    check("single-chip full sort", check_sort_full(got, keys))

    s, b = sort_partial(jax.device_put(keys), 8, 8)
    s = np.asarray(jax.device_get(s))
    check("single-chip partial sort", check_partial(s, keys, 8, 8))
    check(
        "boundary contract",
        np.array_equal(np.asarray(jax.device_get(b)), boundaries_oracle(s, 8, 8)),
    )

    from .utils.checks import check_partial_groups

    s_rc, b_rc = sort_partial(jax.device_put(keys), 8, 8, stable=False)
    check(
        "partial sort stable=False (reference contract)",
        check_partial_groups(np.asarray(jax.device_get(s_rc)), keys, 8, 8)
        and np.array_equal(
            np.asarray(jax.device_get(b_rc)), np.asarray(jax.device_get(b))
        ),
    )

    check("mesh LSD sort", check_sort_full(sort_distributed(keys), keys))
    check("mesh sample sort", check_sort_full(sort_distributed_sample(keys), keys))
    check(
        "storage sort (mem, local)",
        check_sort_full(
            sort_distrib_from_raw(keys, "st_mem", MemArrayFactory(),
                                  local_distrib_worker), keys,
        ),
    )

    from .parallel.storage_sort import sort_distrib_from_raw_kv
    from .utils.keygen import generate_payloads

    payload = generate_payloads(n, payload_bytes=12)
    gk, gp = sort_distrib_from_raw_kv(
        keys, payload, "st_kv", MemArrayFactory()
    )
    order = np.argsort(keys, kind="stable")
    check(
        "storage kv sort (mem, 12B rows)",
        np.array_equal(gk, keys[order]) and np.array_equal(gp, payload[order]),
    )
    from .parallel.pipeline import hash_aggregate_distributed
    from .utils.keygen import generate_zipf_keys

    zk = generate_zipf_keys(max(n // 8, 64), alpha=1.3, seed=2)
    agg_k, agg_c = hash_aggregate_distributed(zk, op="count")
    uk, uc = np.unique(zk, return_counts=True)
    o = np.argsort(agg_k, kind="stable")
    check(
        "hash aggregate (Zipf count)",
        np.array_equal(agg_k[o], uk)
        and np.array_equal(agg_c[o].astype(np.int64), uc),
    )

    fkeys = np.float32(np.asarray(keys).view(np.int32)) / np.float32(997.0)
    got_f = np.asarray(jax.device_get(sort_full(jax.device_put(fkeys))))
    check("typed keys (float32 full sort)",
          np.array_equal(got_f, np.sort(fkeys)))

    # round-4 surfaces: key-ordered group-by and distributed 64-bit keys
    agg_k2, agg_c2 = hash_aggregate_distributed(
        zk, op="count", key_order=True
    )
    check(
        "hash aggregate key_order=True",
        np.array_equal(agg_k2, uk)
        and np.array_equal(agg_c2.astype(np.int64), uc),
    )
    from .parallel.sample_sort import (
        sort_distributed_64,
        sort_key_value_distributed_64,
    )

    k64 = (keys.astype(np.uint64) << np.uint64(32)) | np.roll(
        keys, 1
    ).astype(np.uint64)
    check(
        "distributed 64-bit sort",
        np.array_equal(sort_distributed_64(k64), np.sort(k64)),
    )
    k64s = k64[: max(n // 8, 64)]
    v64 = np.arange(k64s.size, dtype=np.uint32)[:, None]
    gk64, gv64 = sort_key_value_distributed_64(k64s, v64)
    o64 = np.argsort(k64s, kind="stable")
    check(
        "distributed 64-bit kv sort",
        np.array_equal(gk64, k64s[o64]) and np.array_equal(gv64, v64[o64]),
    )

    # round-5 surface: 64-bit keys through the STORAGE plane
    from .parallel.storage_sort import sort_distrib_from_raw_u64

    check(
        "storage 64-bit sort (mem)",
        np.array_equal(
            sort_distrib_from_raw_u64(k64s, "st_u64", MemArrayFactory()),
            np.sort(k64s),
        ),
    )

    if args.subprocess:
        print("  (subprocess workers run on the CPU: platform='cpu')")
        with tempfile.TemporaryDirectory() as mount:
            check(
                "storage sort (file, subprocess)",
                check_sort_full(
                    sort_distrib_from_raw(
                        keys, "st_sub", FileArrayFactory(mount),
                        make_subprocess_worker(mount), width=16,
                    ),
                    keys,
                ),
            )
    print("selftest:", "OK" if not failures else f"FAILED: {failures}")
    return 1 if failures else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpu_radix_sort_tpu",
        description="JAX distributed sort framework",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen", help="generate deterministic uint32 keys")
    g.add_argument("--n", type=int, required=True)
    g.add_argument("--out", required=True)
    g.set_defaults(fn=_cmd_gen)

    s = sub.add_parser("sort", help="sort keys")
    s.add_argument("--mode", choices=["single", "mesh", "sample", "storage"],
                   default="single")
    s.add_argument("--n", type=int, default=None)
    s.add_argument("--in", dest="infile", default=None)
    s.add_argument("--out", default=None)
    # storage-mode knobs default to None (= not explicitly set) so the
    # GRS_* environment keeps the documented precedence: explicit flag >
    # env > dataclass default (utils/config.py).
    s.add_argument("--width", type=int, default=None)
    s.add_argument("--strategy", default=None)
    s.add_argument("--exchange", default="auto")
    s.add_argument("--nworker", type=int, default=None)
    s.add_argument("--backend", default=None)
    s.add_argument("--worker", default=None)
    s.add_argument("--mount", default=None)
    s.add_argument("--checkpoint-dir", default=None)
    s.add_argument("--verify", action="store_true")
    s.set_defaults(fn=_cmd_sort)

    b = sub.add_parser("bench", help="run benchmark suite")
    b.add_argument("--suite", choices=["quick", "full", "scaling"],
                   default="quick")
    b.add_argument("--json", action="store_true")
    b.add_argument("--trace-dir", default=None,
                   help="write a jax.profiler trace here")
    b.set_defaults(fn=_cmd_bench)

    w = sub.add_parser("worker", help="serve one worker event from stdin")
    w.set_defaults(fn=_cmd_worker)

    a = sub.add_parser("analyze", help="analyze/compare bench JSON records")
    a.add_argument("files", nargs="+", help="1 file: cost stacks; 2: compare")
    a.set_defaults(fn=_cmd_analyze)

    t = sub.add_parser("selftest", help="end-to-end exactness checks")
    t.add_argument("--n", type=int, default=100_000)
    t.add_argument("--subprocess", action="store_true",
                   help="include the subprocess-worker path (slow)")
    t.set_defaults(fn=_cmd_selftest)
    return p


def main(argv=None) -> int:
    from .utils.cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
