"""Headline benchmark: single-GPU uint32 full-sort throughput.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device_kind", "device_count", "n"}.  Baseline: the reference's derived
full 32-bit sort rate of ~76M keys/s/GPU (BASELINE.md: 16 two-bit passes on
256Mi keys, summed from nvprof device-activity time,
analysis/libsort8b.csv).  Workload: 256Mi uint32 keys on one card, the
reference's own per-card size.

Measurement: an in-program repeat chain (REP data-dependent sorts per
dispatch), so the figure is device throughput, matching how the baseline
was derived (nvprof sums kernel+memcpy activity and excludes host
dispatch); the single-call median is reported on stderr.  Without a GPU the
script exits non-zero: there is no CPU fallback.

Diagnostics go to stderr; stdout carries exactly the one JSON line.
"""

from __future__ import annotations

import json
import statistics
import sys
import time


BASELINE_KEYS_PER_S = 76e6  # reference full-sort rate per GPU (BASELINE.md)
N = 256 * 1024 * 1024
REP = 10


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    from gpu_radix_sort_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    from jax import lax
    import numpy as np

    import gpu_radix_sort_tpu as gst

    dev = jax.devices()[0]
    log(f"device: {dev} kind={dev.device_kind} count={len(jax.devices())}")
    if dev.platform != "gpu":
        log("FATAL: no GPU; the benchmark does not run on the CPU")
        sys.exit(2)

    n = N
    keys = gst.generate_keys(n)
    dev_keys = jax.device_put(keys, dev)

    fn = jax.jit(lambda k: gst.sort_full(k))

    def chained(k):
        def body(i, acc):
            s = gst.sort_full(acc)
            # Data dependency across iterations defeats CSE, and the remix
            # must actually unsort the stream: a cheap bijection (odd-
            # multiplier + xor-shift) re-randomizes between iterations so a
            # data-dependent sort path can't coast on presorted input.
            x = s * jnp.uint32(0x9E3779B1) + i.astype(jnp.uint32)
            return x ^ (x >> jnp.uint32(16))

        return lax.fori_loop(0, REP, body, k)

    chain_fn = jax.jit(chained)

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(dev_keys))
    log(f"first call (compile+run): {time.perf_counter() - t0:.3f}s")

    # correctness gate before timing
    got = np.asarray(out)
    if not np.array_equal(got, np.sort(keys)):
        log("FATAL: sort output mismatch")
        sys.exit(1)

    reps = 5
    single = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(dev_keys))
        single.append(time.perf_counter() - t0)
    t_single = statistics.median(single)
    log(f"single-call median: {t_single * 1e3:.2f}ms "
        f"({n / t_single / 1e6:.1f}M keys/s incl. dispatch overhead)")

    jax.block_until_ready(chain_fn(dev_keys))  # compile
    chain_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(chain_fn(dev_keys))
        chain_times.append(time.perf_counter() - t0)
    t_sort = statistics.median(chain_times) / REP
    rate = n / t_sort
    log(f"n={n} device-time/sort={t_sort * 1e3:.2f}ms over {REP}-chain x3 "
        f"-> {rate / 1e6:.1f}M keys/s "
        f"(chain times: {[f'{x:.3f}s' for x in chain_times]})")

    print(json.dumps({
        "metric": "keys_per_s_per_chip_full_sort_u32",
        "value": rate,
        "unit": "keys/s",
        "vs_baseline": rate / BASELINE_KEYS_PER_S,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "n": n,
    }))


if __name__ == "__main__":
    main()
