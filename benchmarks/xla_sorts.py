"""Time what XLA makes of the plain sorts on the GPU, and say from the
optimised HLO whether each landed on CUB's radix sort (a custom call) or on
XLA's own sort kernel (a ``sort`` op).

These are the plain-JAX paths that replaced the removed Pallas kernels; the
numbers are the bar a hand-written GPU kernel would have to beat.

    python benchmarks/xla_sorts.py [--reps 5] [--out chiprun_out/xla_sorts.jsonl]

Prints one JSON line per measurement (median of ``--reps`` timed calls
after a warm-up call, each ended by ``block_until_ready``).  Exits non-zero
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def hlo_sort_kinds(compiled_text: str) -> dict:
    """Custom-call targets and the number of XLA ``sort`` ops in an
    optimised HLO module's text."""
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"',
                                    compiled_text)))
    n_sort = len(re.findall(r"=\s*\S+\s+sort\(", compiled_text))
    n_sort += len(re.findall(r"=\s*\([^)]*\)\s+sort\(", compiled_text))
    return {"custom_calls": targets, "xla_sort_ops": n_sort,
            "cub": any("cub" in t.lower() for t in targets)}


def measure(name, fn, args, reps, **extra) -> dict:
    import jax

    jitted = jax.jit(fn)
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    rec = {"name": name, "median_s": statistics.median(times),
           "min_s": min(times), "times_s": times, "compile_s": compile_s,
           **hlo_sort_kinds(compiled.as_text()), **extra}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from gpu_radix_sort_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    import gpu_radix_sort_tpu as gst
    from gpu_radix_sort_tpu.parallel.storage_sort import _fused_row_sorts

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("xla_sorts: no GPU; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = {"device_kind": dev.device_kind, "nvidia_smi": smi}
    key = jax.random.PRNGKey(0)

    def keys(n):
        return jax.random.bits(jax.random.fold_in(key, n), (n,), jnp.uint32)

    runs = []
    # ops/pallas_sort: VMEM bitonic network for small arrays
    for lg in (15, 17):
        runs.append(("jnp_sort_u32", lambda k: jnp.sort(k), (keys(1 << lg),),
                     {"n": 1 << lg, "replaces": "pallas_sort"}))
    # ops/pallas_merge: the full sort, and the storage plane's row sorts
    for lg in (28, 30):
        runs.append(("sort_full_u32", gst.sort_full, (keys(1 << lg),),
                     {"n": 1 << lg, "replaces": "pallas_merge"}))
    z2d = keys(1 << 28).reshape(2, -1)
    runs.append(("fused_row_sorts_batched", lambda z: jnp.sort(z, axis=1),
                 (z2d,), {"n": 1 << 28, "rows": 2,
                          "replaces": "pallas_merge"}))
    runs.append(("fused_row_sorts_per_row", _fused_row_sorts, (z2d,),
                 {"n": 1 << 28, "rows": 2, "replaces": "pallas_merge"}))
    # ops/pallas_radix: digit sorts and the kv digit sort
    x28 = keys(1 << 28)
    for width in (4, 8, 16):
        for stable in (True, False):
            runs.append((
                f"sort_partial_w{width}" + ("" if stable else "_refcontract"),
                lambda k, w=width, st=stable: gst.sort_partial(k, 0, w,
                                                               stable=st),
                (x28,), {"n": 1 << 28, "width": width, "stable": stable,
                         "replaces": "pallas_radix"}))
    runs.append(("sort_key_value_by_digits_w4",
                 lambda k, v: gst.sort_key_value_by_digits(k, v, 0, 4),
                 (x28, jnp.arange(1 << 28, dtype=jnp.uint32)),
                 {"n": 1 << 28, "width": 4, "replaces": "pallas_radix"}))

    out = open(args.out, "w") if args.out else None
    for name, fn, fargs, extra in runs:
        rec = measure(name, fn, fargs, args.reps, **extra, **card)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
