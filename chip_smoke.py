"""Smoke run of the sort engine on NVIDIA GPUs.

Drives the main path once through the public API, at the sizes a user of
one 80 GB card sorts (the original library's own workload is 256Mi keys per
card), and checks every phase exactly against numpy:

    python chip_smoke.py              # one GPU: every single-card phase
    python chip_smoke.py --mesh 4     # only the sharded paths, on 4 GPUs
    python chip_smoke.py --shrink 2   # every size halved twice (printed)

Each phase prints one line ``phase {...}`` with its name, n, bytes on the
device, compile and run seconds, the device's peak bytes in use so far and
``exact``.  The last line of stdout is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

There is no fallback.  Without a GPU, on any mismatch and on any exception
the script exits non-zero and prints no result line; nothing runs in
interpret mode and nothing is caught.  The whole run is one process; the
only child is ``nvidia-smi``, which stays off JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# log2 of each phase's size before --shrink.
SINGLE_SIZES = {
    "sort_full_u32": 30,
    "sort_partial_w8": 28,
    "sort_partial_w16": 28,
    "sort_key_value_u32": 28,
    "sort_key_value_p64B": 26,
    "sort_full_u64": 28,
    "hash_aggregate_count_zipf": 28,
    "storage_device_w8": 28,
}
# log2 of each sharded phase's keys PER CARD before --shrink.
MESH_SIZES = {
    "mesh_sample_sort": 28,
    "mesh_lsd_w8_alltoall": 26,
    "mesh_lsd_w8_overflow": 26,
    "mesh_kv_sample_sort": 26,
    "mesh_sort64": 26,
    "mesh_hash_aggregate_count_zipf": 26,
}
PAYLOAD_BYTES = 64
ZIPF_ALPHA = 1.2


def cut_size(log2n: int, shrink: int) -> tuple[int, str | None]:
    """(n, note): ``2**log2n`` halved ``shrink`` times, and the cut as text
    (None when nothing was cut)."""
    if shrink < 0 or shrink >= log2n:
        raise ValueError(f"shrink must be in [0, {log2n}), got {shrink}")
    n = 1 << (log2n - shrink)
    return n, (f"2^{log2n} halved {shrink}x to 2^{log2n - shrink}"
               if shrink else None)


def result_line(platform: str, kind: str, count: int) -> str:
    """The script's last line of stdout."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind,
                                "count": count}}
    )


def phase_line(name: str, n: int, device_bytes: int, compile_s: float,
               run_s: float, peak_bytes: int, exact: bool,
               cut: str | None, cards: int = 1) -> str:
    """One phase's line; on a mesh ``n`` counts keys per card."""
    rec = {"name": name, "n": n, "cards": cards,
           "device_bytes": device_bytes,
           "compile_s": compile_s, "run_s": run_s,
           "peak_bytes_in_use": peak_bytes, "exact": exact}
    if cut:
        rec["cut"] = cut
    return "phase " + json.dumps(rec)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", type=int, default=0, metavar="P",
                    help="run only the sharded paths, on a mesh of P GPUs")
    ap.add_argument("--shrink", type=int, default=0,
                    help="halve every size this many times")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mesh == 1 or args.mesh < 0:
        ap.error("--mesh takes a device count of at least 2")
    return args


def nvidia_smi() -> list[str]:
    """Name and power limit of every card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


# ---------------------------------------------------------------------------
# Run-time parts (need JAX and a GPU)
# ---------------------------------------------------------------------------

class Smoke:
    def __init__(self, devices, seed: int, shrink: int):
        import jax

        self.jax = jax
        self.devices = devices
        self.key = jax.random.PRNGKey(seed)
        self.seed = seed
        self.shrink = shrink
        self.cards = 1
        self.nphase = 0

    def _key(self):
        self.nphase += 1
        return self.jax.random.fold_in(self.key, self.nphase)

    def random_u32(self, n: int, sharding=None):
        """n uniform uint32 keys made on the device(s) from the seed."""
        import jax.numpy as jnp

        jax = self.jax
        sharding = sharding or jax.sharding.SingleDeviceSharding(
            self.devices[0])
        make = jax.jit(lambda k: jax.random.bits(k, (n,), jnp.uint32),
                       out_shardings=sharding)
        return make(self._key())

    def peak(self) -> int:
        return max(int(d.memory_stats()["peak_bytes_in_use"])
                   for d in self.devices)

    def run(self, name: str, log2n: int, call, check, device_bytes):
        """Call ``call`` twice (the first call compiles), check the second
        call's output, print the phase line; raise on any mismatch."""
        n, cut = cut_size(log2n, self.shrink)
        args = call(n)
        fn, fn_args = args[0], args[1:]
        t0 = time.perf_counter()
        self.jax.block_until_ready(fn(*fn_args))
        t1 = time.perf_counter()
        out = self.jax.block_until_ready(fn(*fn_args))
        t2 = time.perf_counter()
        exact = bool(check(n, fn_args, out))
        compile_s = max((t1 - t0) - (t2 - t1), 0.0)
        print(phase_line(name, n, device_bytes(n), compile_s, t2 - t1,
                         self.peak(), exact, cut, self.cards), flush=True)
        if not exact:
            raise AssertionError(f"phase {name}: output is not exact")


def _stable_order_ok(keys_host, out_keys, order) -> bool:
    """True iff ``order`` is ``np.argsort(keys_host, kind="stable")`` and
    ``out_keys`` the keys in that order — checked without the slow host
    stable argsort: the keys must equal ``np.sort``, ``keys_host[order]``
    must equal them, and within each run of equal keys ``order`` must rise
    strictly.  Those runs then hold exactly the rows of their key, in input
    order, which is the stable argsort."""
    out_keys = np.asarray(out_keys)
    order = np.asarray(order).astype(np.int64)
    if not np.array_equal(out_keys, np.sort(keys_host)):
        return False
    if order.min(initial=0) < 0 or order.max(initial=0) >= keys_host.size:
        return False
    if not np.array_equal(keys_host[order], out_keys):
        return False
    tie = out_keys[1:] == out_keys[:-1]
    return bool(np.all(order[1:][tie] > order[:-1][tie]))


def _payload_lanes(idx, lanes: int):
    """(n, lanes) uint32 payload whose lane 0 is the row index and whose
    other lanes are fixed functions of it."""
    import jax.numpy as jnp

    mult = jnp.asarray(
        [1] + [0x9E3779B1 + 2 * w for w in range(1, lanes)], jnp.uint32)
    salt = jnp.arange(lanes, dtype=jnp.uint32)
    return (idx[:, None] * mult[None, :]) ^ (salt[None, :] * jnp.uint32(
        0x85EBCA6B))


def _payload_lanes_np(idx: np.ndarray, lanes: int) -> np.ndarray:
    mult = np.asarray(
        [1] + [0x9E3779B1 + 2 * w for w in range(1, lanes)], np.uint32)
    salt = np.arange(lanes, dtype=np.uint32)
    return (idx.astype(np.uint32)[:, None] * mult[None, :]) ^ (
        salt[None, :] * np.uint32(0x85EBCA6B))


def single_card_phases(s: Smoke) -> None:
    import jax
    import jax.numpy as jnp

    import gpu_radix_sort_tpu as gst
    from gpu_radix_sort_tpu.data import DeviceArrayFactory
    from gpu_radix_sort_tpu.parallel import (
        hash_aggregate_distributed,
        key_mesh,
        local_distrib_worker,
        sort_distrib_from_raw,
    )
    from gpu_radix_sort_tpu.utils.checks import (
        boundaries_oracle,
        check_partial_groups,
        extract_digits,
    )
    from gpu_radix_sort_tpu.utils.keygen import generate_zipf_keys

    host = {}

    # -- u32 full sort ----------------------------------------------------
    def full_call(n):
        x = s.random_u32(n)
        host["x"] = np.asarray(x)
        return jax.jit(gst.sort_full), x

    s.run("sort_full_u32", SINGLE_SIZES["sort_full_u32"], full_call,
          lambda n, a, out: np.array_equal(np.asarray(out),
                                           np.sort(host["x"])),
          lambda n: 4 * n)

    # -- digit (partial) sorts, stable and reference contract -------------
    for width, offset in ((8, 8), (16, 16)):
        for stable in (True, False):
            def part_call(n, width=width, offset=offset, stable=stable):
                x = s.random_u32(n)
                host["x"] = np.asarray(x)
                return jax.jit(lambda k: gst.sort_partial(
                    k, offset, width, stable=stable)), x

            def part_check(n, a, out, width=width, offset=offset,
                           stable=stable):
                keys = host["x"]
                got, bounds = (np.asarray(o) for o in out)
                if stable:
                    digits = extract_digits(keys, offset, width)
                    narrow = np.uint8 if width <= 8 else np.uint16
                    want = keys[np.argsort(digits.astype(narrow),
                                           kind="stable")]
                    ok = np.array_equal(got, want)
                else:
                    ok = check_partial_groups(got, keys, offset, width)
                return ok and np.array_equal(
                    bounds, boundaries_oracle(got, offset, width))

            name = f"sort_partial_w{width}" + ("" if stable else
                                               "_refcontract")
            s.run(name, SINGLE_SIZES[f"sort_partial_w{width}"], part_call,
                  part_check, lambda n: 4 * n)

    # -- key-value sorts: u32 payload, then 64-byte rows -------------------
    def kv_call(n):
        x = s.random_u32(n)
        host["x"] = np.asarray(x)
        return jax.jit(gst.sort_key_value), x, jnp.arange(n, dtype=jnp.uint32)

    s.run("sort_key_value_u32", SINGLE_SIZES["sort_key_value_u32"], kv_call,
          lambda n, a, out: _stable_order_ok(host["x"], out[0], out[1]),
          lambda n: 8 * n)

    lanes = PAYLOAD_BYTES // 4

    def kv64_call(n):
        x = s.random_u32(n)
        host["x"] = np.asarray(x)
        rows = jax.jit(lambda: jax.lax.bitcast_convert_type(
            _payload_lanes(jnp.arange(n, dtype=jnp.uint32), lanes),
            jnp.uint8).reshape(n, PAYLOAD_BYTES))()
        return jax.jit(gst.sort_key_value), x, rows

    def kv64_check(n, a, out):
        got = np.asarray(out[1]).view(np.uint32).reshape(n, lanes)
        order = got[:, 0]
        return (_stable_order_ok(host["x"], out[0], order)
                and np.array_equal(got, _payload_lanes_np(order, lanes)))

    s.run("sort_key_value_p64B", SINGLE_SIZES["sort_key_value_p64B"],
          kv64_call, kv64_check, lambda n: (4 + PAYLOAD_BYTES) * n)

    # -- 64-bit keys (host-facing) -----------------------------------------
    def u64_call(n):
        hi = np.asarray(s.random_u32(n)).astype(np.uint64)
        lo = np.asarray(s.random_u32(n)).astype(np.uint64)
        host["k64"] = (hi << np.uint64(32)) | lo
        return gst.sort_full_u64, host["k64"]

    s.run("sort_full_u64", SINGLE_SIZES["sort_full_u64"], u64_call,
          lambda n, a, out: np.array_equal(out, np.sort(host["k64"])),
          lambda n: 8 * n)

    # -- group-by count over Zipf keys on a one-card mesh ------------------
    mesh1 = key_mesh(s.devices[:1])

    def agg_call(n):
        host["z"] = generate_zipf_keys(n, alpha=ZIPF_ALPHA, seed=s.seed)
        return (lambda z: hash_aggregate_distributed(z, op="count",
                                                     mesh=mesh1),
                host["z"])

    def agg_check(n, a, out):
        keys, counts = out
        uk, uc = np.unique(host["z"], return_counts=True)
        o = np.argsort(keys)
        return (np.array_equal(keys[o], uk)
                and np.array_equal(counts[o].astype(np.int64), uc))

    s.run("hash_aggregate_count_zipf",
          SINGLE_SIZES["hash_aggregate_count_zipf"], agg_call, agg_check,
          lambda n: 9 * n)

    # -- storage plane, device backend, 2 workers, width 8 ------------------
    def storage_call(n):
        host["x"] = np.asarray(s.random_u32(n))
        calls = iter(range(2))

        def sort(keys):
            return sort_distrib_from_raw(
                keys, f"smoke{next(calls)}", DeviceArrayFactory(),
                local_distrib_worker, width=8, nworker=2)

        return sort, host["x"]

    s.run("storage_device_w8", SINGLE_SIZES["storage_device_w8"],
          storage_call,
          lambda n, a, out: np.array_equal(out, np.sort(host["x"])),
          lambda n: 4 * n)


def _on_distinct_devices(arr, count: int) -> bool:
    return len({sh.device for sh in arr.addressable_shards}) == count


def mesh_phases(s: Smoke, P: int) -> None:
    """The sharded paths on a mesh of P cards, each compared with numpy and
    required to leave its output's shards on P distinct devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as Spec

    from gpu_radix_sort_tpu.parallel import (
        build_distributed_sort,
        build_hash_aggregate,
        build_sample_sort,
        build_sample_sort_64,
        build_sample_sort_kv,
        key_mesh,
    )
    from gpu_radix_sort_tpu.utils.keygen import generate_zipf_keys

    mesh = key_mesh(s.devices[:P])
    shard = NamedSharding(mesh, Spec("x"))
    s.cards = P
    host = {}

    def linearize(padded, counts):
        rows = np.asarray(padded).reshape(P, -1, *np.shape(padded)[1:])
        c = np.asarray(counts).reshape(-1)
        return np.concatenate([rows[i, : c[i]] for i in range(P)])

    def keys_call(n_local):
        x = s.random_u32(n_local * P, shard)
        host["x"] = np.asarray(x)
        return x

    # PSRS
    def psrs_call(n_local):
        fn, _ = build_sample_sort(mesh, n_local)
        return fn, keys_call(n_local)

    def psrs_check(n_local, a, out):
        shards, counts, overflow = out
        return (int(overflow) == 0 and _on_distinct_devices(shards, P)
                and np.array_equal(linearize(shards, counts),
                                   np.sort(host["x"])))

    s.run("mesh_sample_sort", MESH_SIZES["mesh_sample_sort"], psrs_call,
          psrs_check, lambda n: 4 * n * P)

    # LSD rounds, capacity-bounded all-to-all and the two-pass overflow one
    for exchange in ("alltoall", "overflow"):
        def lsd_call(n_local, exchange=exchange):
            fn = build_distributed_sort(mesh, n_local, width=8,
                                        exchange=exchange)
            return fn, keys_call(n_local)

        def lsd_check(n_local, a, out):
            keys, overflow = out
            return (int(overflow) == 0 and _on_distinct_devices(keys, P)
                    and np.array_equal(np.asarray(keys),
                                       np.sort(host["x"])))

        name = f"mesh_lsd_w8_{exchange}"
        s.run(name, MESH_SIZES[name], lsd_call, lsd_check,
              lambda n: 4 * n * P)

    # stable key-value PSRS; the payload is the global row index
    def kv_call(n_local):
        fn, _ = build_sample_sort_kv(mesh, n_local, 1)
        idx = jax.jit(lambda: jnp.arange(n_local * P, dtype=jnp.uint32)
                      .reshape(-1, 1), out_shardings=shard)()
        return fn, keys_call(n_local), idx

    def kv_check(n_local, a, out):
        mk, mv, counts, overflow = out
        return (int(overflow) == 0 and _on_distinct_devices(mk, P)
                and _stable_order_ok(host["x"], linearize(mk, counts),
                                     linearize(mv, counts)[:, 0]))

    s.run("mesh_kv_sample_sort", MESH_SIZES["mesh_kv_sample_sort"], kv_call,
          kv_check, lambda n: 8 * n * P)

    # 64-bit keys as (hi, lo) word lanes
    def s64_call(n_local):
        fn, _ = build_sample_sort_64(mesh, n_local)
        hi = keys_call(n_local)
        hi_host = host["x"]
        lo = keys_call(n_local)
        host["k64"] = (hi_host.astype(np.uint64) << np.uint64(32)) | \
            host["x"].astype(np.uint64)
        return fn, hi, lo

    def s64_check(n_local, a, out):
        mh, ml, counts, overflow = out
        got = (linearize(mh, counts).astype(np.uint64) << np.uint64(32)) | \
            linearize(ml, counts).astype(np.uint64)
        return (int(overflow) == 0 and _on_distinct_devices(mh, P)
                and np.array_equal(got, np.sort(host["k64"])))

    s.run("mesh_sort64", MESH_SIZES["mesh_sort64"], s64_call, s64_check,
          lambda n: 8 * n * P)

    # skew-aware group-by count over Zipf keys
    def agg_call(n_local):
        fn, _ = build_hash_aggregate(mesh, n_local, op="count")
        host["z"] = generate_zipf_keys(n_local * P, alpha=ZIPF_ALPHA,
                                       seed=s.seed)
        z = jax.device_put(host["z"], shard)
        valid = jax.device_put(np.ones(n_local * P, bool), shard)
        return fn, z, z, valid

    def agg_check(n_local, a, out):
        gk, ga, ng, overflow = out
        keys, counts = linearize(gk, ng), linearize(ga, ng)
        uk, uc = np.unique(host["z"], return_counts=True)
        o = np.argsort(keys)
        return (int(overflow) == 0 and _on_distinct_devices(gk, P)
                and np.array_equal(keys[o], uk)
                and np.array_equal(counts[o].astype(np.int64), uc))

    s.run("mesh_hash_aggregate_count_zipf",
          MESH_SIZES["mesh_hash_aggregate_count_zipf"], agg_call, agg_check,
          lambda n: 9 * n * P)


def main(argv=None) -> int:
    args = parse_args(argv)
    from gpu_radix_sort_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is "
              f"{devices[0].platform}); nothing was run", file=sys.stderr)
        return 2
    need = args.mesh or 1
    if len(devices) < need:
        print(f"chip_smoke: --mesh {args.mesh} needs {need} GPUs, JAX sees "
              f"{len(devices)}", file=sys.stderr)
        return 2
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}",
          flush=True)
    for line in nvidia_smi():
        print(f"nvidia-smi: {line}", flush=True)
    s = Smoke(devices, args.seed, args.shrink)
    if args.mesh:
        mesh_phases(s, args.mesh)
    else:
        single_card_phases(s)
    print(result_line(devices[0].platform, devices[0].device_kind,
                      len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
