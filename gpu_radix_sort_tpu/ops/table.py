"""Table operators: hash partition, filter (compaction), group aggregate.

The north-star capability set extends the reference's keys-only sort with
the relational steps its distributed design composes with (BASELINE.json:
"radix hash-partition -> filter -> aggregate ... with sampled splitters").
The reference itself has none of these; designs here are:

  * static shapes everywhere — "filter" returns a packed array + valid
    count (tail padded), never a dynamic-size array;
  * data movement rides the sort machinery (stable key-value sort) rather
    than gathers and scatters;
  * aggregation is segment math over sorted runs, not scatter-adds.

All functions are jit/vmap/shard_map-safe.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from .bits import KEY_DTYPE

# Fibonacci multiplicative hashing: odd constant ≈ 2^32/phi; bijective on
# uint32 (odd multiplier), avalanche-boosted by the xor-shift.
# numpy scalar, NOT jnp: module-scope jax arrays initialize the
# backend at import.
_HASH_MULT = np.uint32(2654435769)


def hash_u32(keys: jnp.ndarray) -> jnp.ndarray:
    """Deterministic uint32 -> uint32 hash (bijective)."""
    x = keys.astype(KEY_DTYPE) * _HASH_MULT
    x = x ^ (x >> jnp.uint32(15))
    x = x * jnp.uint32(0x2C1B3C6D)
    x = x ^ (x >> jnp.uint32(12))
    return x


def hash_partition_ids(keys: jnp.ndarray, nparts: int) -> jnp.ndarray:
    """Radix hash partition: partition id = top log2(nparts) bits of the
    hash (uniform for any key distribution; duplicates co-locate, which is
    what partitioned aggregation wants)."""
    if nparts < 1 or nparts & (nparts - 1):
        # nparts=0 passes the pow2 check alone (0 & -1 == 0) and produces
        # a 33-bit shift — silent garbage ids
        raise ValueError(f"nparts must be a power of 2 >= 1, got {nparts}")
    shift = jnp.uint32(32 - (nparts.bit_length() - 1))
    if nparts == 1:
        return jnp.zeros_like(keys, dtype=jnp.uint32)
    return hash_u32(keys) >> shift


def partition_by_ids(
    keys: jnp.ndarray, part_ids: jnp.ndarray, nparts: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Stable-partition keys by partition id; returns (reordered_keys,
    counts[nparts]).  Run r of the output (starts = exclusive cumsum of
    counts) is partition r — the single-chip analog of one distributed
    exchange round."""
    sorted_ids, reordered = lax.sort_key_val(
        part_ids.astype(jnp.uint32), keys.astype(KEY_DTYPE), is_stable=True
    )
    # counts via searchsorted diffs over the already-sorted ids — scatter-
    # free (bincount lowers to a scatter-add) and reuses the sort this
    # function just paid for.
    queries = jnp.arange(nparts + 1, dtype=jnp.uint32)
    starts = jnp.searchsorted(sorted_ids, queries, side="left")
    counts = (starts[1:] - starts[:-1]).astype(jnp.int32)
    return reordered, counts


def pack_by_mask(mask: jnp.ndarray, *arrays: jnp.ndarray):
    """Stable-pack rows where ``mask`` is True to the front of every array
    simultaneously (one multi-operand sort — a single permutation, so the
    arrays stay row-aligned).  Returns (packed_arrays..., count)."""
    dropped = (~mask).astype(jnp.uint32)
    sorted_ops = lax.sort((dropped, *arrays), num_keys=1, is_stable=True)
    return (*sorted_ops[1:], mask.sum(dtype=jnp.int32))


def compact(
    values: jnp.ndarray, mask: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Filter with static shapes: stable-pack elements where ``mask`` is
    True to the front, preserving order; returns (packed, count).  Elements
    past ``count`` are unspecified.  A dynamic-size result would defeat
    jit."""
    packed, count = pack_by_mask(mask, values)
    return packed, count


def filter_range(
    keys: jnp.ndarray, lo, hi
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Keys in [lo, hi), packed + count."""
    k = keys.astype(KEY_DTYPE)
    return compact(k, (k >= KEY_DTYPE(lo)) & (k < KEY_DTYPE(hi)))


VALID_AGG_OPS = ("sum", "count", "min", "max")


def group_aggregate_sorted(
    sorted_keys: jnp.ndarray,
    values: jnp.ndarray | None = None,
    op: str = "sum",
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Group-by over input with *equal keys adjacent* (key-sorted, or any
    clustering order such as hash order): one output row per distinct run.

    Returns ``(unique_keys, aggregates, ngroups)``, all length n (static
    shape): rows past ``ngroups`` are padding (unspecified).  Entirely
    scatter-free: per-segment aggregates are read off at run ENDS — integer
    sums as cumsum differences (exact under modular wraparound), min/max
    via a segmented associative scan — and one multi-operand pack sort
    moves (key, aggregate) pairs to the front together.  Float sums keep
    segment_sum (a scatter-add) so their rounding order is unchanged.
    ``values=None`` with op="sum"/"count" aggregates 1s.
    """
    if op not in VALID_AGG_OPS:
        raise ValueError(f"op must be one of {VALID_AGG_OPS}, got {op!r}")
    n = sorted_keys.shape[0]
    k = sorted_keys.astype(KEY_DTYPE)
    if values is None and op in ("min", "max"):
        # aggregating implicit 1s under min/max returns all-1s — reject
        # rather than hand back a meaningless result
        raise ValueError(f"op={op!r} requires explicit values")
    if values is None or op == "count":
        values = jnp.ones_like(k, dtype=jnp.uint32 if op == "count" else jnp.float32)
        if op == "count":
            op = "sum"
    if n == 0:
        return k, values, jnp.int32(0)

    boundary = k[1:] != k[:-1]
    is_start = jnp.concatenate([jnp.ones((1,), bool), boundary])
    is_end = jnp.concatenate([boundary, jnp.ones((1,), bool)])

    if op == "sum" and jnp.issubdtype(values.dtype, jnp.floating):
        # float rounding order must match the scatter formulation callers
        # compare against; integer paths below are exact either way
        seg_ids = jnp.cumsum(is_start.astype(jnp.int32)) - 1
        agg_rows = jax.ops.segment_sum(values, seg_ids, num_segments=n)
        uniq, cnt = compact(k, is_start)
        return uniq, agg_rows, jnp.int32(cnt)

    if op == "sum":
        csum = jnp.cumsum(values)  # wraps mod 2^bits; diffs recover exactly
        uniq, ecsum, cnt = pack_by_mask(is_end, k, csum)
        prev = jnp.concatenate([jnp.zeros((1,), csum.dtype), ecsum[:-1]])
        return uniq, ecsum - prev, jnp.int32(cnt)

    # min/max: inclusive segmented scan (value at a run's end row is the
    # run aggregate), then pack the end rows.
    combine = jnp.minimum if op == "min" else jnp.maximum
    def seg_combine(a, b):  # a = earlier prefix, b = later
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, combine(va, vb))

    _, scanned = jax.lax.associative_scan(seg_combine, (is_start, values))
    uniq, agg, cnt = pack_by_mask(is_end, k, scanned)
    return uniq, agg, jnp.int32(cnt)


def group_aggregate(
    keys: jnp.ndarray,
    values: jnp.ndarray | None = None,
    op: str = "sum",
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Group-by over unsorted input: stable kv-sort then segment reduce.
    This is also the local *combiner* of the distributed pipeline (pre-
    aggregating duplicates before the exchange is what neutralizes Zipf
    skew — a hot key becomes one row per chip)."""
    if values is None:
        sorted_keys = jnp.sort(keys.astype(KEY_DTYPE))
        return group_aggregate_sorted(sorted_keys, None, op)
    sorted_keys, sorted_vals = lax.sort_key_val(
        keys.astype(KEY_DTYPE), values, is_stable=True
    )
    return group_aggregate_sorted(sorted_keys, sorted_vals, op)
