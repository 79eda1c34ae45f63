"""Storage-mediated bulk-synchronous distributed radix sort.

Capability mirror of the reference's Go orchestration layer
(benchmark/pkg/sort/distrib.go): ``32/width`` rounds; each round merges the
previous round's per-digit buckets across workers (STRIDED BucketReader),
splits the stream into byte-balanced PartRef shards, and hands each shard to
a pluggable :data:`DistribWorker` that partial-sorts it on the device and
writes one output partition per digit bucket.

This is the *storage plane* path — data moves through DistribArrays
(memory / file / device-HBM backends) and workers are pluggable, including
out-of-process subprocess workers (parallel/serverless.py).  The
collective mesh path (parallel/distributed.py) is the performance path; this one exists
for the reference's capability surface: heterogeneous workers, spill beyond
device memory, multi-process execution, and per-round checkpoint/resume
(which the reference's README notes as a natural extension of its round
structure — SURVEY.md §5).

Improvements over the reference kept deliberately:
  * ``nworker`` is a parameter, not hard-coded 2 (distrib.go:107).
  * Bucket metadata is exact per-digit counts (ops/boundaries.digit_counts),
    not the quirky boundary contract (empty-group backfill) — equivalent
    sizes, no JSON.
  * Worker shard splits are rounded to whole keys (4-byte multiples).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Protocol, Sequence

import numpy as np

from ..data.interface import ArrayFactory, DistribArray, PartRef, create_shape
from ..data.helpers import fetch_part_refs, fetch_part_refs_u32
from ..utils.timers import SortStats
from ..utils.transfer import chunked_device_get
from .bucket_reader import BucketReader, ReadOrder

KEY_BYTES = 4
TOTAL_BITS = 32


_JIT_CACHE: dict = {}


def _jitted_sort_partial_counts():
    """Process-wide jitted partial sort (one compile cache across workers;
    XLA re-specializes per (shape, offset, width, strategy))."""
    fn = _JIT_CACHE.get("sort_partial_counts")
    if fn is None:
        import jax

        from ..ops.radix_sort import sort_partial_counts

        fn = jax.jit(
            sort_partial_counts,
            static_argnums=(1, 2),
            static_argnames=("strategy",),
        )
        _JIT_CACHE["sort_partial_counts"] = fn
    return fn


def _jitted_digit_order_counts():
    """Process-wide jitted (stable digit argsort, exact digit counts) over
    uint32 keys — the device computation of the kv-row worker (only keys
    travel to the chip; payload rows are permuted host-side)."""
    fn = _JIT_CACHE.get("digit_order_counts")
    if fn is None:
        import jax
        import jax.numpy as jnp
        from jax import lax

        from ..ops.bits import extract_digits

        def f(keys, offset, width):
            digits = extract_digits(keys, offset, width)
            if width <= 8:
                digits = digits.astype(jnp.uint8)  # faster, smaller sort
            elif width <= 16:
                digits = digits.astype(jnp.uint16)
            idx = jnp.arange(keys.shape[0], dtype=jnp.uint32)
            sorted_digits, order = lax.sort_key_val(
                digits, idx, is_stable=True
            )
            queries = jnp.arange((1 << width) + 1, dtype=jnp.uint32)
            starts = jnp.searchsorted(sorted_digits, queries, side="left")
            return order, (starts[1:] - starts[:-1]).astype(jnp.int32)

        fn = jax.jit(f, static_argnums=(1, 2))
        _JIT_CACHE["digit_order_counts"] = fn
    return fn


def _worker_vlog(out_name: str, msg: str) -> None:
    """Worker progress breadcrumbs under GRS_VERBOSE=1: they mark which
    phase a long round is in."""
    if os.environ.get("GRS_VERBOSE"):
        print(f"[worker {out_name}] {msg}", file=sys.stderr, flush=True)


class DistribWorker(Protocol):
    """One round's unit of work (reference: the DistribWorker plugin type,
    distrib.go:23): gather ``in_refs``, stable-sort by bits
    [offset, offset+width), create an array named ``out_name`` with 2^width
    partitions (partition d = bucket d's bytes), commit and return it."""

    def __call__(
        self,
        in_refs: Sequence[PartRef],
        offset: int,
        width: int,
        out_name: str,
        factory: ArrayFactory,
    ) -> DistribArray: ...


def _device_refs(in_refs: Sequence[PartRef]) -> bool:
    return all(getattr(r.arr, "device_native", False) for r in in_refs)


def _local_distrib_worker_device(
    in_refs: Sequence[PartRef],
    offset: int,
    width: int,
    out_name: str,
    factory: ArrayFactory,
    *,
    strategy: str | None = None,
) -> DistribArray:
    """Zero-host-copy round: gather on device (lazy slices of committed
    HBM backings), jitted partial sort, commit the sorted backing via
    ``put_device_packed`` — buckets never leave HBM between rounds.  The
    GPU reference pays H2D+D2H every round (~46% of its partial-sort GPU
    time, SURVEY.md §3); this path is why the device backend exists
    (data/device.py:1-16).  Only the (2^width,) counts cross to host."""
    import jax
    import jax.numpy as jnp

    segs = [
        r.arr.device_range(r.part_idx, r.start, r.nbyte)
        for r in in_refs
        if r.nbyte > 0
    ]
    segs = [s for s in segs if s is not None and s.shape[0]]
    if not segs:
        out = factory.create(out_name, create_shape([0] * (1 << width)))
        out.close()
        return out
    raw = segs[0] if len(segs) == 1 else jnp.concatenate(segs)
    if raw.shape[0] % KEY_BYTES:
        raise ValueError(f"gathered {raw.shape[0]} bytes, not 4-aligned")
    keys = jax.lax.bitcast_convert_type(
        raw.reshape(-1, KEY_BYTES), jnp.uint32
    )
    n = keys.shape[0]
    # Same pow2 padding contract as the host worker (keeps jit caches warm);
    # pad keys 0xFFFFFFFF sort to the tail of the last bucket.
    n_pad = 1 << max(n - 1, 1).bit_length()
    padded = jnp.concatenate(
        [keys, jnp.full((n_pad - n,), jnp.uint32(0xFFFFFFFF), jnp.uint32)]
    )
    sorted_keys, counts = _jitted_sort_partial_counts()(
        padded, offset, width, strategy=strategy
    )
    counts = np.asarray(jax.device_get(counts), dtype=np.int64)
    counts[-1] -= n_pad - n
    backing = jax.lax.bitcast_convert_type(sorted_keys[:n], jnp.uint8).reshape(
        -1
    )
    caps = counts * KEY_BYTES
    out = factory.create(out_name, create_shape(caps.tolist()))
    out.put_device_packed(backing, caps.tolist())
    out.close()
    return out


def local_distrib_worker(
    in_refs: Sequence[PartRef],
    offset: int,
    width: int,
    out_name: str,
    factory: ArrayFactory,
    *,
    strategy: str | None = None,
) -> DistribArray:
    """In-process device worker (reference: LocalDistribWorker,
    distrib.go:25-84): fetch → device partial sort → bucket-partitioned
    output array.  When the factory and every input array are device-native
    the whole round stays in HBM (see _local_distrib_worker_device)."""
    import jax

    if getattr(factory, "device_native", False) and _device_refs(in_refs):
        return _local_distrib_worker_device(
            in_refs, offset, width, out_name, factory, strategy=strategy
        )
    keys = fetch_part_refs_u32(in_refs)
    n = keys.size
    # Shard sizes are data-dependent (byte-balanced splits), so jitting on
    # the raw shape would recompile every round/worker — ruinous where
    # compiles are expensive.  Pad to the next power of two: pad keys are
    # 0xFFFFFFFF, whose digit is maximal at ANY (offset, width), so after a
    # stable digit sort they occupy the tail of the last bucket — slice
    # them off and deduct them from that bucket's count.
    n_pad = 1 << max(n - 1, 1).bit_length()
    padded = np.full(n_pad, 0xFFFFFFFF, dtype=np.uint32)
    padded[:n] = keys
    _worker_vlog(out_name, f"fetched n={n:,} (pad {n_pad:,}); device sort")
    sorted_keys, counts = _jitted_sort_partial_counts()(
        padded, offset, width, strategy=strategy
    )
    counts = np.asarray(jax.device_get(counts), dtype=np.int64)
    counts[-1] -= n_pad - n
    # limit=n keeps the pow2 pad tail off the wire.
    host_sorted = chunked_device_get(sorted_keys, limit=n)
    _worker_vlog(out_name, "sorted keys on host; writing buckets")

    caps = counts * KEY_BYTES
    out = factory.create(out_name, create_shape(caps.tolist()))
    offsets = np.concatenate([[0], np.cumsum(counts)])
    view = memoryview(np.ascontiguousarray(host_sorted).view(np.uint8))
    for d in range(1 << width):
        lo, hi = int(offsets[d]) * KEY_BYTES, int(offsets[d + 1]) * KEY_BYTES
        if hi > lo:
            out.write_part(d, view[lo:hi])
    out.close()
    return out


def _fused_stack_fn():
    """Jitted (N,) -> (W, n_pad) re-stack: static byte-balanced split of the
    strided stream into worker rows, each padded to n_pad with 0xFFFFFFFF
    (max digit at any (offset, width), deducted from the last bucket)."""
    fn = _JIT_CACHE.get("fused_stack")
    if fn is None:
        import jax
        import jax.numpy as jnp

        def f(keys, k_ws, n_pad):
            rows, pos = [], 0
            for k in k_ws:
                seg = keys[pos : pos + k]
                pos += k
                if n_pad > k:
                    seg = jnp.concatenate(
                        [seg, jnp.full((n_pad - k,), 0xFFFFFFFF, jnp.uint32)]
                    )
                rows.append(seg)
            return jnp.stack(rows)

        fn = jax.jit(f, static_argnums=(1, 2))
        _JIT_CACHE["fused_stack"] = fn
    return fn


def _fused_row_sorts(z2d):
    """Ascending keys-only sort of each row of a (W, n_pad) uint32 array,
    one ``sort_full`` per row (unrolled over the static W).  On an H100 a
    per-row sort lands on CUB's radix sort, while the batched
    ``jnp.sort(z2d, axis=1)`` runs XLA's own sort kernel, 29x slower at
    (2, 2^27) (PERF.md)."""
    import jax.numpy as jnp

    from ..ops.radix_sort import sort_full

    return jnp.stack([sort_full(z2d[w]) for w in range(z2d.shape[0])])


def _fused_round_jit():
    """The whole device round as ONE jitted program —
    strided-stream rebuild + per-worker digit sort + exact counts + packed
    commit backing, for ALL workers.  Every sort is a KEYS-ONLY
    rotated-value sort: round k's
    required order (digit_k, bits [0, k*w), high bits) is the plain
    ascending order of z = rotr(x, (k+1)*w), so

      rebuild   one keys-only sort of rotr(flat, offset) == the STRIDED
                (digit, worker, rank) merge of the previous round's buckets
                (the legacy path's per-worker gathers + BucketReader
                metadata, distrib.go:113-140, collapse into this one sort);
                re-split at the static byte-balanced bounds;
      sort      per-worker keys-only row sorts of rotr(row, offset+width)
                (keys-only, in place of the composite (row*D+digit, key)
                pair sort it replaced);
      counts    per-row searchsorted over the D digit boundaries (digits
                are the TOP width bits of z);
      packed    valid-prefix concat, bitcast u8 — put_device_packed fodder.

    Validity: worker shards are contiguous slices of the strided stream,
    which is elementwise nondecreasing in bits [0, k*w) by induction, so
    the byte-balanced cuts land on slices of the bits-[0,(k+1)w)-sorted
    order — the same argument as the mesh loop's _fused_sort_shard.  Pad
    slots hold literal 0xFFFFFFFF, whose rotation is 0xFFFFFFFF: a pad can
    only tie with a real key of IDENTICAL value, so taking the first
    k_ws[w] keys after each sort keeps the exact multiset (the sanctioned
    keys-only sentinel exception).  Within-bucket tie order for keys equal
    in (digit, low bits) but differing in high bits becomes value order
    instead of arrival order — multiset-identical per bucket, so counts,
    partition lens, and every later round are unchanged, and the final
    stream is the unique sorted multiset either way.

    Dispatch count per round: 1 program + 1 counts D2H (the legacy path
    issues dozens of lazy ops per worker)."""
    fn = _JIT_CACHE.get("fused_round")
    if fn is None:
        import jax
        import jax.numpy as jnp
        from jax import lax

        from ..ops.bits import rotr32
        from ..ops.radix_sort import sort_full

        def f(stacked, offset, width, k_ws, rebuild):
            W, n_pad = stacked.shape
            D = 1 << width
            k_arr = np.asarray(k_ws)
            if rebuild:
                zs = sort_full(rotr32(stacked.reshape(-1), offset))
                stream = rotr32(zs, 32 - offset)
                bounds = np.concatenate([[0], np.cumsum(k_arr)])
                rows = []
                for w in range(W):
                    seg = stream[int(bounds[w]) : int(bounds[w + 1])]
                    if n_pad > k_ws[w]:
                        seg = jnp.concatenate([
                            seg,
                            jnp.full(
                                (n_pad - k_ws[w],), 0xFFFFFFFF, jnp.uint32
                            ),
                        ])
                    rows.append(seg)
                stacked = jnp.stack(rows)
            rot = (offset + width) % 32
            z2s = _fused_row_sorts(rotr32(stacked, rot))
            sorted_stacked = rotr32(z2s, (32 - rot) % 32)
            # digit_k == the TOP width bits of z: per-row counts are D-1
            # searchsorteds against the digit boundaries d << (32-width).
            q = jnp.arange(1, D, dtype=jnp.uint32) << jnp.uint32(32 - width)
            starts = jax.vmap(
                lambda r: jnp.searchsorted(r, q, side="left")
            )(z2s).astype(jnp.int32)
            b = jnp.concatenate(
                [
                    jnp.zeros((W, 1), jnp.int32),
                    starts,
                    jnp.full((W, 1), n_pad, jnp.int32),
                ],
                axis=1,
            )
            counts = b[:, 1:] - b[:, :-1]
            packed32 = jnp.concatenate(
                [sorted_stacked[w, : k_ws[w]] for w in range(W)]
            )
            packed = lax.bitcast_convert_type(packed32, jnp.uint8).reshape(-1)
            return sorted_stacked, counts, packed

        fn = jax.jit(f, static_argnums=(1, 2, 3, 4))
        _JIT_CACHE["fused_round"] = fn
    return fn


def _fused_allrounds_jit():
    """EVERY round in ONE jitted program (engaged when nothing observes
    intermediate rounds, i.e. ``checkpoint_dir is None``): the storage twin
    of the mesh plane's _fused_sort_shard.

    Round k's per-shard digit sort and round k+1's strided bucket merge
    are BOTH subsumed by one global keys-only sort of z = rotr(x, (k+1)w):
    the sorted stream is value-identical to the strided merge of the
    per-shard-digit-sorted buckets (same multiset, nondecreasing in bits
    [0,(k+1)w)), and every slice of it is already z-sorted, i.e. digit-
    sorted — so the separate per-shard sort would be redundant work.
    Consecutive rounds compose in z-space (rotr(rotl(z, (k+1)w), (k+2)w)
    == rotr(z, w)), so the loop is nstep-1 global sorts with ONE trailing
    un-rotation; only the FINAL round's shard structure is observable
    (counts + packed per worker), so it alone re-stacks at the static
    byte-balanced bounds and row-sorts by plain value (the identity
    rotation).  Per sort, pads are literal 0xFFFFFFFF and tie only with
    identical real keys — positions [0, N) hold the exact valid multiset
    throughout (the sanctioned keys-only sentinel exception).

    Dispatch count for the WHOLE multi-round sort: 1 program + 1 counts
    D2H, against one program and one readback per round for the per-round
    fused loop."""
    fn = _JIT_CACHE.get("fused_allrounds")
    if fn is None:
        import jax
        import jax.numpy as jnp
        from jax import lax

        from ..ops.bits import rotr32
        from ..ops.radix_sort import sort_full

        def f(stacked, width, k_ws, start_step, nstep):
            W, n_pad = stacked.shape
            D = 1 << width
            k_arr = np.asarray(k_ws)
            bounds = np.concatenate([[0], np.cumsum(k_arr)])
            zs = rotr32(
                stacked.reshape(-1), ((start_step + 1) * width) % 32
            )
            for step in range(start_step, nstep - 1):
                zs = sort_full(zs)
                zs = rotr32(zs, width)  # z_{k} -> z_{k+1} space
            stream = rotr32(zs, (32 - (nstep * width) % 32) % 32)
            rows = []
            for w in range(W):
                seg = stream[int(bounds[w]) : int(bounds[w + 1])]
                if n_pad > k_ws[w]:
                    seg = jnp.concatenate([
                        seg,
                        jnp.full((n_pad - k_ws[w],), 0xFFFFFFFF, jnp.uint32),
                    ])
                rows.append(seg)
            stacked = jnp.stack(rows)
            # final round: rotation is the identity (offset + width == 32)
            sorted_stacked = _fused_row_sorts(stacked)
            q = jnp.arange(1, D, dtype=jnp.uint32) << jnp.uint32(32 - width)
            starts = jax.vmap(
                lambda r: jnp.searchsorted(r, q, side="left")
            )(sorted_stacked).astype(jnp.int32)
            b = jnp.concatenate(
                [
                    jnp.zeros((W, 1), jnp.int32),
                    starts,
                    jnp.full((W, 1), n_pad, jnp.int32),
                ],
                axis=1,
            )
            counts = b[:, 1:] - b[:, :-1]
            packed32 = jnp.concatenate(
                [sorted_stacked[w, : k_ws[w]] for w in range(W)]
            )
            packed = lax.bitcast_convert_type(packed32, jnp.uint8).reshape(-1)
            return sorted_stacked, counts, packed

        fn = jax.jit(f, static_argnums=(1, 2, 3, 4))
        _JIT_CACHE["fused_allrounds"] = fn
    return fn


def _fused_allrounds64_jit():
    """EVERY 64-bit round in ONE jitted program — the u64 twin of
    :func:`_fused_allrounds_jit`, with the rotated-value identity lifted to
    64 bits held as (hi, lo) uint32 word lanes (ops/bits.rotr64_lanes; no
    uint64 on device, no jax_enable_x64).  Round k's order is the plain
    ascending order of z = rotr64(enc, (k+1)w), a 2-lane lexicographic
    sort (lax.sort num_keys=2); consecutive rounds compose as rotr64 by w;
    the final round re-stacks at the static byte-balanced bounds and
    row-sorts by value (identity rotation), with digit counts read off the
    hi lane's top ``width`` bits.  Pads are 0xFFFFFFFF in BOTH lanes
    (= u64 +inf; rotations fix all-ones) and tie only with value-identical
    real keys — the sanctioned keys-only sentinel exception."""
    fn = _JIT_CACHE.get("fused_allrounds64")
    if fn is None:
        import jax
        import jax.numpy as jnp
        from jax import lax

        from ..ops.bits import rotr64_lanes

        def f(hi, lo, width, k_ws, start_step, nstep):
            W, n_pad = hi.shape
            D = 1 << width
            k_arr = np.asarray(k_ws)
            bounds = np.concatenate([[0], np.cumsum(k_arr)])
            zh, zl = rotr64_lanes(
                hi.reshape(-1), lo.reshape(-1),
                ((start_step + 1) * width) % 64,
            )
            for step in range(start_step, nstep - 1):
                zh, zl = lax.sort((zh, zl), num_keys=2)
                zh, zl = rotr64_lanes(zh, zl, width)  # z_k -> z_{k+1}
            zh, zl = rotr64_lanes(zh, zl, (64 - (nstep * width) % 64) % 64)

            def restack(stream):
                rows = []
                for w in range(W):
                    seg = stream[int(bounds[w]) : int(bounds[w + 1])]
                    if n_pad > k_ws[w]:
                        seg = jnp.concatenate([
                            seg,
                            jnp.full(
                                (n_pad - k_ws[w],), 0xFFFFFFFF, jnp.uint32
                            ),
                        ])
                    rows.append(seg)
                return jnp.stack(rows)

            sh, sl = restack(zh), restack(zl)
            # final round: identity rotation -> plain 2-lane row sorts
            sh, sl = lax.sort((sh, sl), dimension=1, num_keys=2)
            q = jnp.arange(1, D, dtype=jnp.uint32) << jnp.uint32(32 - width)
            starts = jax.vmap(
                lambda r: jnp.searchsorted(r, q, side="left")
            )(sh).astype(jnp.int32)
            b = jnp.concatenate(
                [
                    jnp.zeros((W, 1), jnp.int32),
                    starts,
                    jnp.full((W, 1), n_pad, jnp.int32),
                ],
                axis=1,
            )
            counts = b[:, 1:] - b[:, :-1]
            packed_pairs = jnp.concatenate(
                [
                    jnp.stack(
                        [sl[w, : k_ws[w]], sh[w, : k_ws[w]]], axis=1
                    )  # (k, 2): [lo, hi] -> little-endian u64 rows
                    for w in range(W)
                ]
            )
            packed = lax.bitcast_convert_type(
                packed_pairs, jnp.uint8
            ).reshape(-1)
            return sh, sl, counts, packed

        fn = jax.jit(f, static_argnums=(2, 3, 4, 5))
        _JIT_CACHE["fused_allrounds64"] = fn
    return fn


def _fused_linearize64_jit():
    """Final 64-bit linearization: ONE 2-lane value sort of the carried
    lanes (pads are +inf and tie only with identical real keys), emitted
    as little-endian 8-byte rows."""
    fn = _JIT_CACHE.get("fused_linearize64")
    if fn is None:
        import jax
        import jax.numpy as jnp
        from jax import lax

        def f(hi, lo, k_ws):
            n = int(sum(k_ws))
            zh, zl = lax.sort(
                (hi.reshape(-1), lo.reshape(-1)), num_keys=2
            )
            pairs = jnp.stack([zl[:n], zh[:n]], axis=1)
            return lax.bitcast_convert_type(pairs, jnp.uint8).reshape(-1)

        fn = jax.jit(f, static_argnums=(2,))
        _JIT_CACHE["fused_linearize64"] = fn
    return fn


def _fused_device_eligible64(factory, worker, arrs, row_bytes: int) -> bool:
    """The u64 fused device loop serves the stock 64-bit keys-only worker
    over device-native arrays (same contract-preserving bypass as
    :func:`_fused_device_eligible`)."""
    return (
        row_bytes == 8
        and getattr(worker, "_fused64_ok", False)
        and getattr(factory, "device_native", False)
        and bool(arrs)
        and all(getattr(a, "device_native", False) for a in arrs)
        and sum(sum(a.get_shape().lens) for a in arrs) > 0
    )


def _sort_rounds_device_fused64(
    inputs: Sequence[DistribArray],
    name: str,
    factory: ArrayFactory,
    *,
    width: int,
    nworker: int,
    start_step: int,
    stats: SortStats,
) -> list[DistribArray]:
    """Device-resident 64-bit round loop: 1 program + 1 counts D2H for the
    whole 64/width-round sort (the u64 twin of
    :func:`_sort_rounds_device_fused`; engaged when nothing observes
    intermediate rounds, i.e. ``checkpoint_dir is None``)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    nstep = 64 // width
    arrs = list(inputs)
    shapes = [a.get_shape() for a in arrs]
    total = sum(sum(s.lens) for s in shapes)
    if total % 8:
        raise ValueError(f"stream of {total} bytes is not 8-aligned")
    N = total // 8
    per_b = math.ceil(total / max(nworker, 1))
    per_b += (-per_b) % 8
    per = per_b // 8
    bounds = [min(w * per, N) for w in range(nworker + 1)]
    k_ws = tuple(bounds[w + 1] - bounds[w] for w in range(nworker))
    n_pad = 1 << max(max(k_ws) - 1, 1).bit_length()

    with stats.time("split"):
        segs = []
        npart = max(s.npart for s in shapes)
        for d in range(npart):
            for a, s in zip(arrs, shapes):
                if d < s.npart and s.lens[d]:
                    segs.append(a.device_range(d))
        stream0 = segs[0] if len(segs) == 1 else jnp.concatenate(segs)
        words = lax.bitcast_convert_type(
            stream0.reshape(-1, 4), jnp.uint32
        ).reshape(-1, 2)  # little-endian rows: col 0 = lo, col 1 = hi
        stack = _fused_stack_fn()
        hi = stack(words[:, 1], k_ws, n_pad)
        lo = stack(words[:, 0], k_ws, n_pad)

    with stats.time("round_sort"):
        sh, sl, counts_dev, packed = _fused_allrounds64_jit()(
            hi, lo, width, k_ws, start_step, nstep
        )
        jax.block_until_ready((sh, sl, counts_dev, packed))
    with stats.time("counts_d2h"):
        counts = np.asarray(jax.device_get(counts_dev), dtype=np.int64)
    for w in range(nworker):
        counts[w, -1] -= n_pad - k_ws[w]
    outputs = []
    with stats.time("commit"):
        for w in range(nworker):
            caps = (counts[w] * 8).tolist()
            out = factory.create(
                f"{name}.s{nstep - 1}.w{w}", create_shape(caps)
            )
            out.put_device_packed(
                packed[bounds[w] * 8 : bounds[w + 1] * 8], caps
            )
            out.close()
            outputs.append(out)
    with stats.time("destroy"):
        for a in arrs:
            a.destroy()
    stats.add("rounds", nstep - start_step)
    cell = [(sh, sl)]

    def _fused_linearize64(_cell=cell):
        h, l = _cell.pop()
        return np.asarray(
            chunked_device_get(_fused_linearize64_jit()(h, l, k_ws)),
            dtype=np.uint8,
        )

    outputs[0]._fused_linearize64 = _fused_linearize64
    return outputs


def _fused_linearize_jit():
    """Jitted final linearization: after the last round the strided stream
    is the fully sorted array, i.e. ONE keys-only value sort of the carried
    flat (rotr by 32 is the identity rotation); pads (0xFFFFFFFF) tie only
    with identical real keys, so the valid prefix is value-exact.  ONE
    program + ONE D2H for the whole result."""
    fn = _JIT_CACHE.get("fused_linearize")
    if fn is None:
        import jax

        from ..ops.radix_sort import sort_full

        def f(stacked, k_ws):
            zs = sort_full(stacked.reshape(-1))
            return zs[: int(sum(k_ws))]

        fn = jax.jit(f, static_argnums=(1,))
        _JIT_CACHE["fused_linearize"] = fn
    return fn


def _fused_device_eligible(factory, worker, arrs, row_bytes: int) -> bool:
    """The fused single-program device round loop preserves the legacy
    path's contract exactly (names, partition contents, counts, checkpoint
    manifests) but bypasses the worker callable — so it only engages for
    the stock local worker with no pinned kernel strategy."""
    return (
        row_bytes == KEY_BYTES
        and getattr(worker, "_fused_device_strategy", "off") is None
        and getattr(factory, "device_native", False)
        and bool(arrs)
        and all(getattr(a, "device_native", False) for a in arrs)
        and sum(sum(a.get_shape().lens) for a in arrs) > 0
    )


def _sort_rounds_device_fused(
    inputs: Sequence[DistribArray],
    name: str,
    factory: ArrayFactory,
    *,
    width: int,
    nworker: int,
    start_step: int,
    stats: SortStats,
    checkpoint_dir: str | None,
) -> list[DistribArray]:
    """Device-resident round loop fused to ~2 dispatches per round
    (one jitted round program, one counts readback).  The (W, n_pad)
    stacked shard tensor is carried directly between rounds; the committed
    DistribArrays are packed lazy views over the same HBM data, serving
    checkpoint manifests, BucketReader fallbacks, and the reference's
    output contract (distrib.go:90-176)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    nstep = TOTAL_BITS // width
    arrs = list(inputs)
    shapes = [a.get_shape() for a in arrs]
    total = sum(sum(s.lens) for s in shapes)
    if total % KEY_BYTES:
        raise ValueError(f"stream of {total} bytes is not 4-aligned")
    N = total // KEY_BYTES
    per_b = math.ceil(total / max(nworker, 1))
    per_b += (-per_b) % KEY_BYTES
    per = per_b // KEY_BYTES
    bounds = [min(w * per, N) for w in range(nworker + 1)]
    k_ws = tuple(bounds[w + 1] - bounds[w] for w in range(nworker))
    n_pad = 1 << max(max(k_ws) - 1, 1).bit_length()

    verbose = bool(os.environ.get("GRS_VERBOSE"))

    def _vlog(msg: str) -> None:
        if verbose:
            print(
                f"[sort_distrib {name}] (fused) {msg}", file=sys.stderr,
                flush=True,
            )

    # One-time ragged gather: lazy device slices in STRIDED order (the
    # only place partition raggedness reaches the op stream; every later
    # round rebuilds the stream inside the jitted program).
    with stats.time("split"):
        segs = []
        npart = max(s.npart for s in shapes)
        for d in range(npart):
            for a, s in zip(arrs, shapes):
                if d < s.npart and s.lens[d]:
                    segs.append(a.device_range(d))
        stream0 = segs[0] if len(segs) == 1 else jnp.concatenate(segs)
        keys0 = lax.bitcast_convert_type(
            stream0.reshape(-1, KEY_BYTES), jnp.uint32
        )
        stacked = _fused_stack_fn()(keys0, k_ws, n_pad)

    if checkpoint_dir is None:
        # Nothing observes intermediate rounds (no checkpoint manifests):
        # run EVERY round in one program — 1 dispatch + 1 counts D2H for
        # the whole sort (see _fused_allrounds_jit).
        with stats.time("round_sort"):
            stacked, counts_dev, packed = _fused_allrounds_jit()(
                stacked, width, k_ws, start_step, nstep
            )
            jax.block_until_ready((stacked, counts_dev, packed))
        with stats.time("counts_d2h"):
            counts = np.asarray(jax.device_get(counts_dev), dtype=np.int64)
        for w in range(nworker):
            counts[w, -1] -= n_pad - k_ws[w]
        outputs = []
        with stats.time("commit"):
            for w in range(nworker):
                caps = (counts[w] * KEY_BYTES).tolist()
                out = factory.create(
                    f"{name}.s{nstep - 1}.w{w}", create_shape(caps)
                )
                out.put_device_packed(
                    packed[bounds[w] * KEY_BYTES : bounds[w + 1] * KEY_BYTES],
                    caps,
                )
                out.close()
                outputs.append(out)
        with stats.time("destroy"):
            for a in arrs:
                a.destroy()
        stats.add("rounds", nstep - start_step)
        _vlog(f"all {nstep - start_step} rounds in one program")
        arrs = outputs
        cell = [stacked]

        def _fused_linearize(_cell=cell):
            return _fused_linearize_jit()(_cell.pop(), k_ws)

        arrs[0]._fused_linearize = _fused_linearize
        return arrs

    fused = _fused_round_jit()
    for step in range(start_step, nstep):
        offset = step * width
        t_round = time.monotonic()
        # Phase breakdown: round_sort is the device program to completion
        # (block on every output, not just counts); counts_d2h is the only
        # per-round host readback; commit is pure metadata (the packed
        # backing never leaves device memory).
        with stats.time("round_sort"):
            stacked, counts_dev, packed = fused(
                stacked, offset, width, k_ws, step > start_step
            )
            jax.block_until_ready((stacked, counts_dev, packed))
        with stats.time("counts_d2h"):
            counts = np.asarray(jax.device_get(counts_dev), dtype=np.int64)
        for w in range(nworker):
            counts[w, -1] -= n_pad - k_ws[w]  # pow2 pad keys, last bucket
        outputs = []
        with stats.time("commit"):
            for w in range(nworker):
                caps = (counts[w] * KEY_BYTES).tolist()
                out = factory.create(
                    f"{name}.s{step}.w{w}", create_shape(caps)
                )
                out.put_device_packed(
                    packed[bounds[w] * KEY_BYTES : bounds[w + 1] * KEY_BYTES],
                    caps,
                )
                out.close()
                outputs.append(out)
        _vlog(
            f"round {step + 1}/{nstep} done in "
            f"{time.monotonic() - t_round:.1f}s"
        )
        if checkpoint_dir is not None:
            with stats.time("checkpoint"):
                _write_checkpoint(
                    checkpoint_dir, name, step, width, outputs
                )
        with stats.time("destroy"):
            for a in arrs:
                a.destroy()
        arrs = outputs
        stats.add("rounds", 1)

    # Hand _linearize_device a ONE-SHOT one-program stream rebuild (the
    # generic per-partition walk would issue up to W * 2^width lazy
    # slices).  The stacked tensor lives in a pop-once cell so a caller
    # that keeps the output arrays alive is not pinning a second full
    # copy of the dataset in HBM after linearization consumed it.
    cell = [stacked]

    def _fused_linearize(_cell=cell):
        return _fused_linearize_jit()(_cell.pop(), k_ws)

    arrs[0]._fused_linearize = _fused_linearize
    return arrs


# Stock worker, no pinned strategy: eligible for the fused device loop.
local_distrib_worker._fused_device_strategy = None


def _split_refs(
    arrs: Sequence[DistribArray], nworker: int, row_bytes: int = KEY_BYTES
) -> list[list[PartRef]]:
    """Byte-balanced shard split of the STRIDED bucket merge (reference:
    distrib.go:113-140), rounded to whole rows (uint32 keys, or fixed-width
    key+payload rows for the kv plane)."""
    reader = BucketReader(arrs, ReadOrder.STRIDED)
    total = reader.total_bytes
    per_worker = math.ceil(total / max(nworker, 1))
    per_worker += (-per_worker) % row_bytes
    return [reader.read_ref(per_worker) for _ in range(nworker)]


def _checkpoint_path(checkpoint_dir: str, name: str) -> str:
    return os.path.join(checkpoint_dir, f"{name}.ckpt.json")


def _write_checkpoint(
    checkpoint_dir: str, name: str, step: int, width: int, arrs,
    row_bytes: int = KEY_BYTES, total_bits: int = TOTAL_BITS,
) -> None:
    os.makedirs(checkpoint_dir, exist_ok=True)
    payload = json.dumps(
        {
            "name": name,
            "completed_step": step,
            "width": width,
            "nworker": len(arrs),
            "row_bytes": row_bytes,
            "total_bits": total_bits,
            "arrays": [a.name for a in arrs],
        }
    )
    path = _checkpoint_path(checkpoint_dir, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)


def load_checkpoint(checkpoint_dir: str, name: str) -> dict | None:
    """The last committed round's manifest, or None if never checkpointed."""
    path = _checkpoint_path(checkpoint_dir, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def sort_distrib_from_arr(
    inputs: Sequence[DistribArray],
    name: str,
    factory: ArrayFactory,
    worker: DistribWorker,
    *,
    width: int = 8,
    nworker: int = 2,
    start_step: int = 0,
    stats: SortStats | None = None,
    checkpoint_dir: str | None = None,
    row_bytes: int = KEY_BYTES,
    total_bits: int = TOTAL_BITS,
) -> list[DistribArray]:
    """The bulk-synchronous round loop (reference: SortDistribFromArr,
    distrib.go:90-176).  Consumes (destroys) ``inputs``; returns the final
    round's output arrays — ``nworker`` arrays of 2^width partitions whose
    STRIDED traversal is the fully sorted key stream.

    ``checkpoint_dir`` enables explicit per-round persistence: after each
    round a manifest records the round's output array names; with a durable
    (file) factory, :func:`resume_sort_distrib` can continue after a crash
    from the last committed round.

    ``total_bits=64`` runs ``64/width`` rounds over 8-byte keys (workers
    built with ``key_bits=64``; width must also divide 32 so digit windows
    never straddle the key's word boundary).
    """
    if total_bits not in (32, 64):
        raise ValueError(f"total_bits must be 32 or 64, got {total_bits}")
    if width <= 0 or total_bits % width or 32 % width:
        raise ValueError(
            f"width {width} must divide 32 and {total_bits}"
        )
    if total_bits == 64 and row_bytes < 8:
        raise ValueError(
            f"total_bits=64 needs >= 8-byte rows, got row_bytes={row_bytes}"
        )
    if nworker < 1:
        raise ValueError(f"nworker must be >= 1, got {nworker}")
    stats = stats if stats is not None else SortStats()
    if total_bits == TOTAL_BITS and _fused_device_eligible(
        factory, worker, list(inputs), row_bytes
    ):
        return _sort_rounds_device_fused(
            inputs,
            name,
            factory,
            width=width,
            nworker=nworker,
            start_step=start_step,
            stats=stats,
            checkpoint_dir=checkpoint_dir,
        )
    if (
        total_bits == 64
        and checkpoint_dir is None  # nothing observes intermediate rounds
        and _fused_device_eligible64(factory, worker, list(inputs), row_bytes)
    ):
        return _sort_rounds_device_fused64(
            inputs,
            name,
            factory,
            width=width,
            nworker=nworker,
            start_step=start_step,
            stats=stats,
        )
    nstep = total_bits // width
    arrs: list[DistribArray] = list(inputs)

    verbose = bool(os.environ.get("GRS_VERBOSE"))

    def _vlog(msg: str) -> None:
        if verbose:
            print(f"[sort_distrib {name}] {msg}", file=sys.stderr, flush=True)

    for step in range(start_step, nstep):
        offset = step * width
        t_round = time.monotonic()
        with stats.time("split"):
            shards = _split_refs(arrs, nworker, row_bytes)
        _vlog(f"round {step + 1}/{nstep} offset={offset}: "
              f"{[sum(r.nbyte for r in s) for s in shards]} bytes/shard")
        with stats.time("workers"):
            with ThreadPoolExecutor(max_workers=nworker) as pool:
                futures = [
                    pool.submit(
                        worker,
                        refs,
                        offset,
                        width,
                        f"{name}.s{step}.w{i}",
                        factory,
                    )
                    for i, refs in enumerate(shards)
                ]
                outputs = [f.result() for f in futures]
        _vlog(f"round {step + 1}/{nstep} done in "
              f"{time.monotonic() - t_round:.1f}s")
        if checkpoint_dir is not None:
            with stats.time("checkpoint"):
                _write_checkpoint(
                    checkpoint_dir, name, step, width, outputs, row_bytes,
                    total_bits,
                )
        with stats.time("destroy"):
            for a in arrs:
                a.destroy()
        arrs = outputs
        stats.add("rounds", 1)
    return arrs


def resume_sort_distrib(
    name: str,
    factory: ArrayFactory,
    worker: DistribWorker,
    checkpoint_dir: str,
    *,
    nworker: int = 2,
    stats: SortStats | None = None,
) -> list[DistribArray]:
    """Continue a checkpointed sort from its last committed round."""
    ckpt = load_checkpoint(checkpoint_dir, name)
    if ckpt is None:
        raise FileNotFoundError(
            f"no checkpoint for {name!r} under {checkpoint_dir}"
        )
    arrs = [factory.open(n) for n in ckpt["arrays"]]
    # Clear partial outputs of the crashed round (the round after the last
    # committed one may have created some worker arrays before dying).
    # The crashed run's nworker may exceed the resume-time nworker — sweep
    # up to the larger of the two so no stale '{name}.sN.wI' arrays leak
    # (older checkpoints without the field fall back to the current value).
    total_bits = int(ckpt.get("total_bits", TOTAL_BITS))
    nstep = total_bits // ckpt["width"]
    sweep = max(int(ckpt.get("nworker", nworker)), nworker)
    for s in range(ckpt["completed_step"] + 1, nstep):
        for i in range(sweep):
            factory.destroy_named(f"{name}.s{s}.w{i}")
    return sort_distrib_from_arr(
        arrs,
        name,
        factory,
        worker,
        width=ckpt["width"],
        nworker=nworker,
        start_step=ckpt["completed_step"] + 1,
        stats=stats,
        checkpoint_dir=checkpoint_dir,
        row_bytes=int(ckpt.get("row_bytes", KEY_BYTES)),
        total_bits=total_bits,
    )


def _linearize_device(outputs: Sequence[DistribArray]):
    """STRIDED linearization entirely on device (one concat + ONE D2H
    transfer) when every output array is device-native; None otherwise.
    The per-partition host reads of BucketReader would cost
    nworker * 2^width device-to-host transfers."""
    if not outputs or not all(
        getattr(a, "device_native", False) for a in outputs
    ):
        return None
    import jax
    import jax.numpy as jnp

    fused = getattr(outputs[0], "_fused_linearize", None)
    if fused is not None:
        # Fused round loop: the stream is ONE jitted rebuild over the
        # carried stacked tensor + ONE D2H, not W * 2^width lazy slices.
        # The hook is one-shot (it pops its tensor cell, releasing the
        # HBM reference) — drop it so a repeat linearization falls back
        # to the generic per-partition path below.
        out = np.asarray(chunked_device_get(fused()), dtype=np.uint32)
        del outputs[0]._fused_linearize
        return out

    shapes = [a.get_shape() for a in outputs]
    npart = max(s.npart for s in shapes)
    segs = []
    for d in range(npart):
        for a, s in zip(outputs, shapes):
            if d < s.npart and s.lens[d]:
                segs.append(a.device_range(d))
    if not segs:
        return np.empty(0, np.uint32)
    stream = segs[0] if len(segs) == 1 else jnp.concatenate(segs)
    host = np.asarray(chunked_device_get(stream))
    return host.view(np.uint32)


def sort_distrib_from_raw(
    keys,
    name: str,
    factory: ArrayFactory,
    worker: DistribWorker = local_distrib_worker,
    *,
    width: int = 8,
    nworker: int = 2,
    stats: SortStats | None = None,
    checkpoint_dir: str | None = None,
) -> np.ndarray:
    """Host-facing wrapper (reference: SortDistribFromRaw,
    distrib.go:183-248): stage raw keys into a 1-partition input array, run
    the round loop, linearize the final buckets via a STRIDED BucketReader,
    destroy the outputs, return the sorted uint32 array."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    stats = stats if stats is not None else SortStats()
    nbytes = keys.size * KEY_BYTES

    with stats.time("stage_input"):
        arr_in = factory.create(f"{name}.input", create_shape([nbytes]))
        arr_in.write_part(0, keys.tobytes())
        arr_in.close()

    outputs = sort_distrib_from_arr(
        [arr_in],
        name,
        factory,
        worker,
        width=width,
        nworker=nworker,
        stats=stats,
        checkpoint_dir=checkpoint_dir,
    )

    with stats.time("linearize"):
        result = _linearize_device(outputs)
        if result is None:
            raw = BucketReader(outputs, ReadOrder.STRIDED).read()
            result = np.frombuffer(raw, dtype=np.uint32)
    for a in outputs:
        a.destroy()
    if result.size != keys.size:
        raise IOError(
            f"linearized {result.size} keys, expected {keys.size}"
        )
    return result


def local_distrib_worker_kv(
    in_refs: Sequence[PartRef],
    offset: int,
    width: int,
    out_name: str,
    factory: ArrayFactory,
    *,
    row_bytes: int,
    key_bits: int = 32,
) -> DistribArray:
    """KV-row worker: rows are fixed-width [key | payload] byte records
    moving through the byte-blind plane (the reference's data plane is
    type-blind bytes throughout — benchmark/pkg/data/file.go; its worker
    only ever interpreted them as u32 keys, distrib.go:25-84).

    ``key_bits=32``: a 4B uint32 key leads each row.  ``key_bits=64``: an
    8B little-endian order-encoded word leads each row (ops/bits
    encode_ordered_np64) and ``offset`` addresses bits of the 64-bit key —
    the digit window [offset, offset+width) lives entirely in word
    ``offset // 32`` because width divides 32, so each round still moves
    exactly ONE 4-byte lane to the chip (beyond the reference's u32-only
    surface, libsort.h:19).

    Division of labor: only the 4B digit word travels to the
    chip (the stable digit argsort + exact counts run jitted on device);
    payload rows are permuted host-side by the returned order, next to the
    storage they came from — shipping W-byte payloads through the
    host<->device link to sort on a 4B key would multiply transfer volume
    by (W+4)/4 for zero compute benefit.
    """
    if key_bits not in (32, 64):
        raise ValueError(f"key_bits must be 32 or 64, got {key_bits}")
    key_bytes = key_bits // 8
    if row_bytes < key_bytes or (key_bits == 32 and row_bytes == KEY_BYTES):
        raise ValueError(
            f"row_bytes {row_bytes} too small for key_bits {key_bits}"
        )
    if offset + width > key_bits or (offset % 32) + width > 32:
        raise ValueError(
            f"digit window [{offset}, {offset + width}) invalid for "
            f"key_bits {key_bits} (must lie within one 32-bit word)"
        )
    import jax

    buf = fetch_part_refs(in_refs)
    if len(buf) % row_bytes:
        raise ValueError(
            f"gathered {len(buf)} bytes, not a multiple of row_bytes "
            f"{row_bytes}"
        )
    rows = np.frombuffer(buf, dtype=np.uint8).reshape(-1, row_bytes)
    n = rows.shape[0]
    # Digit word: little-endian word offset // 32 of the key (always word 0
    # for 32-bit keys); the device offset is the bit offset WITHIN it.
    col = KEY_BYTES * (offset // 32)
    offset = offset % 32
    keys = np.ascontiguousarray(
        rows[:, col : col + KEY_BYTES]
    ).view(np.uint32).reshape(-1)
    # Same pow2-padding contract as the keys-only worker: pad keys
    # 0xFFFFFFFF have the maximal digit at any (offset, width), so the
    # stable argsort puts every pad index at the global tail — order[:n]
    # is exactly the permutation of the real rows.
    n_pad = 1 << max(n - 1, 1).bit_length()
    padded = np.full(n_pad, 0xFFFFFFFF, dtype=np.uint32)
    padded[:n] = keys
    _worker_vlog(out_name, f"fetched n={n:,} rows; device digit argsort")
    order, counts = _jitted_digit_order_counts()(padded, offset, width)
    order = chunked_device_get(order, limit=n)  # pad tail stays on device
    counts = np.asarray(jax.device_get(counts), dtype=np.int64)
    counts[-1] -= n_pad - n

    _worker_vlog(out_name, "order on host; permuting rows")
    rows_sorted = rows[order]  # host permutation of full rows
    caps = counts * row_bytes
    out = factory.create(out_name, create_shape(caps.tolist()))
    offsets = np.concatenate([[0], np.cumsum(counts)])
    flat = memoryview(rows_sorted.reshape(-1))
    for d in range(1 << width):
        lo = int(offsets[d]) * row_bytes
        hi = int(offsets[d + 1]) * row_bytes
        if hi > lo:
            out.write_part(d, flat[lo:hi])
    out.close()
    return out


def sort_distrib_from_raw_kv(
    keys,
    payload,
    name: str,
    factory: ArrayFactory,
    worker: DistribWorker | None = None,
    *,
    width: int = 8,
    nworker: int = 2,
    stats: SortStats | None = None,
    checkpoint_dir: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Storage-mediated distributed stable key-value sort (BASELINE.json
    config 3's engine): interleave keys with fixed-width payload rows, run
    the multi-round loop through the byte-blind plane, split the linearized
    rows back.  ``payload``: (n, B) uint8.  Returns (sorted_keys,
    payload_in_sorted_order) matching a stable single-host kv sort.
    """
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    n = keys.size
    if payload.ndim != 2 or payload.shape[0] != n:
        raise ValueError(
            f"payload must be (n, B) uint8 with n == len(keys); got "
            f"{payload.shape} for n={n}"
        )
    row_bytes = KEY_BYTES + payload.shape[1]
    stats = stats if stats is not None else SortStats()
    if worker is None:
        worker = make_kv_worker(row_bytes)

    with stats.time("stage_input"):
        rows = np.empty((n, row_bytes), dtype=np.uint8)
        rows[:, :KEY_BYTES] = keys.view(np.uint8).reshape(n, KEY_BYTES)
        rows[:, KEY_BYTES:] = payload
        arr_in = factory.create(
            f"{name}.input", create_shape([n * row_bytes])
        )
        arr_in.write_part(0, memoryview(rows.reshape(-1)))
        arr_in.close()

    outputs = sort_distrib_from_arr(
        [arr_in],
        name,
        factory,
        worker,
        width=width,
        nworker=nworker,
        stats=stats,
        checkpoint_dir=checkpoint_dir,
        row_bytes=row_bytes,
    )

    with stats.time("linearize"):
        raw = BucketReader(outputs, ReadOrder.STRIDED).read()
        got = np.frombuffer(raw, dtype=np.uint8).reshape(-1, row_bytes)
    for a in outputs:
        a.destroy()
    if got.shape[0] != n:
        raise IOError(f"linearized {got.shape[0]} rows, expected {n}")
    out_keys = np.ascontiguousarray(got[:, :KEY_BYTES]).view(
        np.uint32
    ).reshape(-1)
    out_payload = np.ascontiguousarray(got[:, KEY_BYTES:])
    return out_keys, out_payload


def make_kv_worker(row_bytes: int, key_bits: int = 32) -> DistribWorker:
    """A kv-row DistribWorker with the row width (and key width) pinned —
    the round loop's worker signature stays the reference's 5-argument
    contract."""

    def worker(in_refs, offset, width, out_name, factory):
        return local_distrib_worker_kv(
            in_refs, offset, width, out_name, factory, row_bytes=row_bytes,
            key_bits=key_bits,
        )

    # 8-byte keys-only 64-bit rows are eligible for the fused u64 device
    # loop (contract-preserving bypass, _fused_device_eligible64)
    worker._fused64_ok = key_bits == 64 and row_bytes == 8
    return worker


def _encode_rows_64(keys) -> tuple[np.ndarray, np.dtype, int]:
    """64-bit keys -> (n, 8) little-endian order-encoded byte rows."""
    from ..ops.bits import encode_ordered_np64

    keys = np.asarray(keys)
    if keys.dtype not in (np.uint64, np.int64, np.float64):
        raise TypeError(
            f"64-bit storage sorts take uint64/int64/float64 keys, got "
            f"{keys.dtype}"
        )
    enc = np.ascontiguousarray(encode_ordered_np64(keys), dtype="<u8")
    return enc.view(np.uint8).reshape(-1, 8), keys.dtype, keys.size


def _decode_rows_64(rows: np.ndarray, dtype) -> np.ndarray:
    from ..ops.bits import decode_ordered_np64

    enc = np.ascontiguousarray(rows).view("<u8").reshape(-1)
    return decode_ordered_np64(enc, dtype)


def sort_distrib_from_raw_u64(
    keys,
    name: str,
    factory: ArrayFactory,
    worker: DistribWorker | None = None,
    *,
    width: int = 8,
    nworker: int = 2,
    stats: SortStats | None = None,
    checkpoint_dir: str | None = None,
) -> np.ndarray:
    """Storage-mediated distributed sort of 64-BIT keys (uint64 / int64 /
    float64 totalOrder) — the storage-plane twin of
    :func:`ops.radix_sort.sort_full_u64`, beyond the reference's u32-only
    surface (libsort.h:19).  ``64/width`` LSD rounds over 8-byte
    order-encoded rows; each round's worker moves only the 4-byte digit
    word to the chip (:func:`local_distrib_worker_kv` with key_bits=64).
    Checkpoint/resume works unchanged (the manifest records total_bits).
    """
    rows, dtype, n = _encode_rows_64(keys)
    stats = stats if stats is not None else SortStats()
    if worker is None:
        worker = make_kv_worker(8, key_bits=64)

    with stats.time("stage_input"):
        arr_in = factory.create(f"{name}.input", create_shape([n * 8]))
        arr_in.write_part(0, memoryview(np.ascontiguousarray(rows).reshape(-1)))
        arr_in.close()

    outputs = sort_distrib_from_arr(
        [arr_in],
        name,
        factory,
        worker,
        width=width,
        nworker=nworker,
        stats=stats,
        checkpoint_dir=checkpoint_dir,
        row_bytes=8,
        total_bits=64,
    )

    with stats.time("linearize"):
        fused = getattr(outputs[0], "_fused_linearize64", None)
        if fused is not None:
            # fused u64 device loop: ONE jitted 2-lane sort + ONE D2H
            # instead of nworker * 2^width host partition reads
            got = fused().reshape(-1, 8)
            del outputs[0]._fused_linearize64
        else:
            raw = BucketReader(outputs, ReadOrder.STRIDED).read()
            got = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 8)
    for a in outputs:
        a.destroy()
    if got.shape[0] != n:
        raise IOError(f"linearized {got.shape[0]} rows, expected {n}")
    return _decode_rows_64(got, dtype)


def sort_distrib_from_raw_kv64(
    keys,
    payload,
    name: str,
    factory: ArrayFactory,
    worker: DistribWorker | None = None,
    *,
    width: int = 8,
    nworker: int = 2,
    stats: SortStats | None = None,
    checkpoint_dir: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Storage-mediated distributed STABLE key-value sort with 64-bit keys:
    rows are [8B order-encoded key | payload]; ties keep input order
    (every round's digit argsort is stable).  Returns (sorted_keys,
    payload_in_sorted_order).  ``payload``: (n, B) uint8."""
    enc_rows, dtype, n = _encode_rows_64(keys)
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    if payload.ndim != 2 or payload.shape[0] != n:
        raise ValueError(
            f"payload must be (n, B) uint8 with n == len(keys); got "
            f"{payload.shape} for n={n}"
        )
    row_bytes = 8 + payload.shape[1]
    stats = stats if stats is not None else SortStats()
    if worker is None:
        worker = make_kv_worker(row_bytes, key_bits=64)

    with stats.time("stage_input"):
        rows = np.empty((n, row_bytes), dtype=np.uint8)
        rows[:, :8] = enc_rows
        rows[:, 8:] = payload
        arr_in = factory.create(
            f"{name}.input", create_shape([n * row_bytes])
        )
        arr_in.write_part(0, memoryview(rows.reshape(-1)))
        arr_in.close()

    outputs = sort_distrib_from_arr(
        [arr_in],
        name,
        factory,
        worker,
        width=width,
        nworker=nworker,
        stats=stats,
        checkpoint_dir=checkpoint_dir,
        row_bytes=row_bytes,
        total_bits=64,
    )

    with stats.time("linearize"):
        raw = BucketReader(outputs, ReadOrder.STRIDED).read()
        got = np.frombuffer(raw, dtype=np.uint8).reshape(-1, row_bytes)
    for a in outputs:
        a.destroy()
    if got.shape[0] != n:
        raise IOError(f"linearized {got.shape[0]} rows, expected {n}")
    out_keys = _decode_rows_64(got[:, :8], dtype)
    return out_keys, np.ascontiguousarray(got[:, 8:])


def make_local_worker(strategy: str | None = None) -> DistribWorker:
    """A LocalDistribWorker with a pinned single-chip sort strategy."""

    def worker(in_refs, offset, width, out_name, factory):
        return local_distrib_worker(
            in_refs, offset, width, out_name, factory, strategy=strategy
        )

    # Fused device loop only when no kernel strategy is pinned (the fused
    # program digit-sorts with lax.sort_key_val; a pinned strategy must go
    # through sort_partial_counts per worker).
    worker._fused_device_strategy = strategy
    return worker
