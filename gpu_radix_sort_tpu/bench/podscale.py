"""Pod-scale compile-only gate: lower + compile the sharded programs at P
devices WITHOUT executing.

A CPU host cannot always EXECUTE virtual meshes beyond 8 devices (XLA's CPU
collective rendezvous aborts if all P device threads do not arrive within
its timeout), but lower/compile works at any P — which is exactly the evidence the
pod-slice north star (BASELINE.json config 4) needs from one host: the
``send_windows`` lax.map rewrite (parallel/exchange.py) claims HLO size
and compile time are P-INDEPENDENT, so pod-scale programs must compile
~flat vs P=8 rather than bloating with unrolled per-peer slices.

Reference analog: the scaling story this guards is the reference's whole
benchmark design (reference benchmark/README.md,
benchmark/pkg/sort/distrib.go:90-176 — worker count as a free parameter).

Run (env BEFORE jax init; the driver test spawns this as a subprocess):

    JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=64 \
    python -m gpu_radix_sort_tpu.bench.podscale --devices 64 --json

Prints one JSON object per line: {"program", "devices", "lower_s",
"compile_s", "hlo_chars"}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


N_LOCAL = 2048  # tiny shard: compile cost is structural, not data-sized
KV_LANES = 2


def _programs(mesh, n_local: int):
    """(name, jitted_fn, abstract_args) for every pod-scale program."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.distributed import build_distributed_sort
    from ..parallel.mesh import KEY_AXIS
    from ..parallel.pipeline import build_hash_aggregate
    from ..parallel.sample_sort import build_sample_sort, build_sample_sort_kv

    nchips = mesh.shape[KEY_AXIS]
    sh = NamedSharding(mesh, P(KEY_AXIS))
    keys = jax.ShapeDtypeStruct((nchips * n_local,), jnp.uint32, sharding=sh)
    vals = jax.ShapeDtypeStruct(
        (nchips * n_local, KV_LANES), jnp.uint32, sharding=sh
    )
    valid = jax.ShapeDtypeStruct((nchips * n_local,), jnp.bool_, sharding=sh)

    out = []
    for width in (8, 16):
        fn = build_distributed_sort(
            mesh, n_local, width=width, exchange="alltoall"
        )
        out.append((f"lsd_w{width}", fn, (keys,)))
    fn, _ = build_sample_sort(mesh, n_local)
    out.append(("psrs", fn, (keys,)))
    fn, _ = build_sample_sort_kv(mesh, n_local, KV_LANES)
    out.append(("psrs_kv", fn, (keys, vals)))
    fn, _ = build_hash_aggregate(mesh, n_local, op="count")
    out.append(("hash_aggregate", fn, (keys, keys, valid)))
    return out


def run(devices: int, n_local: int = N_LOCAL) -> list[dict]:
    import jax

    from ..parallel.mesh import key_mesh

    devs = jax.devices("cpu")
    if len(devs) < devices:
        raise RuntimeError(
            f"need {devices} CPU devices, have {len(devs)}; set "
            "XLA_FLAGS=--xla_force_host_platform_device_count"
        )
    mesh = key_mesh(devs[:devices])
    records = []
    for name, fn, args in _programs(mesh, n_local):
        t0 = time.perf_counter()
        lowered = fn.lower(*args)
        t1 = time.perf_counter()
        hlo_chars = len(lowered.as_text())
        t2 = time.perf_counter()
        lowered.compile()
        t3 = time.perf_counter()
        records.append(
            {
                "program": name,
                "devices": devices,
                "n_local": n_local,
                "lower_s": round(t1 - t0, 4),
                "compile_s": round(t3 - t2, 4),
                "hlo_chars": hlo_chars,
            }
        )
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, required=True)
    ap.add_argument("--n-local", type=int, default=N_LOCAL)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    for rec in run(args.devices, args.n_local):
        if args.json:
            print(json.dumps(rec))
        else:
            print(
                f"{rec['program']:>16} P={rec['devices']:<4} "
                f"lower {rec['lower_s']:.2f}s compile {rec['compile_s']:.2f}s "
                f"hlo {rec['hlo_chars']/1e6:.2f}M chars"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
