"""Distributed hash-partition → filter → aggregate pipeline (skew-aware).

The north-star composition (BASELINE.json config 5): Zipf-distributed keys,
sampled splitters, radix hash-partition, filter, aggregate — on the device
mesh.  No reference equivalent; designed around the same
scatter-free machinery as the sort paths:

  1. **Local filter** (optional predicate): compaction, not dynamic shapes.
  2. **Local combine**: group-aggregate duplicates on each chip first
     (ops/table.group_aggregate).  This is the skew neutralizer — a Zipf
     hot key collapses to ONE row per chip before any communication, so
     the exchange load is bounded by *distinct* keys regardless of how
     skewed the value distribution is.
  3. **Sampled-splitter exchange on hashed keys**: combined rows are
     ordered by key hash; P-quantile samples are all-gathered and re-sorted
     and their regular quantiles become splitters (the PSRS scheme,
     parallel/sample_sort.py) so every chip receives a balanced hash range
     even when per-chip distinct-key counts differ.  Row payloads move by
     capacity-bounded `lax.all_to_all`; overflow is detected, never silent.
  4. **Final aggregate**: each chip owns disjoint hash ranges; a second
     group-aggregate merges per-chip partials (sum/min/max merge with the
     same op; count merges with sum).

Validity is tracked by *packing* (valid rows first + a count), never by
sentinel keys — full-range uint32 keys, including 0xFFFFFFFF, are handled
exactly; padding rows are neutralized by rewriting them to the first valid
row's key with the aggregation identity as value.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.bits import KEY_DTYPE
from ..ops.table import VALID_AGG_OPS, group_aggregate_sorted, hash_u32
from .exchange import default_capacity, send_windows
from .mesh import KEY_AXIS, key_mesh

# numpy scalar, NOT jnp: module-scope jax arrays initialize the backend
# at import.
HASH_PAD = np.uint32(0xFFFFFFFF)


def _identity(op: str, dtype) -> jnp.ndarray:
    if op in ("sum", "count"):
        return jnp.zeros((), dtype)
    info = (
        jnp.finfo(dtype) if jnp.issubdtype(dtype, jnp.floating) else jnp.iinfo(dtype)
    )
    return jnp.array(info.max if op == "min" else info.min, dtype)


def _neutralize_tail(keys, vals, count, op):
    """Rewrite rows at index >= count to (keys[0], identity): they merge
    into an existing group (when count > 0) contributing nothing."""
    idx = jnp.arange(keys.shape[0], dtype=jnp.int32)
    valid = idx < count
    keys = jnp.where(valid, keys, keys[0])
    vals = jnp.where(valid, vals, _identity(op, vals.dtype))
    return keys, vals


def _combine_sorted(keys, values, kept, merge_op):
    """Group-aggregate over a (valid-prefix) KEY-SORTED array: rows past
    ``kept`` are rewritten to the LAST valid key with identity values so
    they extend the final group (preserving sortedness — unlike
    _neutralize_tail's keys[0], which would start a duplicate group at the
    tail of a sorted array).  Returns (uniq, agg, ngroups)."""
    idx = jnp.arange(keys.shape[0], dtype=jnp.int32)
    last_key = jnp.take(keys, jnp.maximum(kept - 1, 0))
    valid = idx < kept
    keys = jnp.where(valid, keys, last_key)
    values = jnp.where(valid, values, _identity(merge_op, values.dtype))
    uniq, agg, ng = group_aggregate_sorted(keys, values, merge_op)
    return uniq, agg, jnp.where(kept > 0, ng, 0)


def _pipeline_shard(keys, values, row_valid, *, axis, capacity, op, predicate):
    P_ = lax.axis_size(axis)
    my = lax.axis_index(axis)
    n = keys.shape[0]
    merge_op = "sum" if op == "count" else op

    # 1+2+3a. filter, HASH ORDER, and local combine in ONE multi-key sort:
    # primary key = dropped flag (valid rows pack to the front), secondary =
    # key hash, tertiary = key.  Equal keys hash equally, so the valid
    # prefix comes out with equal keys adjacent (all group_aggregate needs)
    # AND already in the (hash, key) order the splitter exchange wants —
    # the round-2 design paid a second full-size multi-operand sort to
    # reorder the combined rows by hash; fusing the hash in here deletes it
    # (measured: the shard was 3 full sorts, this removes one whole one).
    mask = row_valid
    if predicate is not None:
        mask = mask & predicate(keys)
    if op == "count":
        # Materialize count as sum-of-ones HERE so padding rows can carry
        # an explicit 0 (group_aggregate's own count mode would re-count
        # every row, padding included).
        values = jnp.ones((n,), jnp.uint32)
    dropped = (~mask).astype(jnp.uint32)
    _, _, keys, values = lax.sort(
        (dropped, hash_u32(keys), keys, values), num_keys=3, is_stable=True
    )
    kept = mask.sum(dtype=jnp.int32)
    uniq_s, agg_s, ng = _combine_sorted(keys, values, kept, merge_op)
    uniq_s, agg_s = _neutralize_tail(uniq_s, agg_s, ng, merge_op)

    # 3b. splitters over the hash order; exchange ---------------------------
    # Combined rows are already hash-ordered (group_aggregate_sorted packs
    # groups preserving input order); padding positions (idx >= ng) present
    # as HASH_PAD, which sorts at/after every real hash, so the first `ng`
    # positions are exactly the valid rows even when a real hash equals
    # HASH_PAD.  No permutation gathers anywhere.
    idx = jnp.arange(n, dtype=jnp.int32)
    h_sorted = jnp.where(idx < ng, hash_u32(uniq_s), HASH_PAD)

    # Regular sampling of the VALID prefix (positions i*ng/P, tiny gather).
    # Decomposed so i*ng never materializes: at pod scale (P=256,
    # ng~2^24) the product exceeds int32 and wrapped to NEGATIVE sample
    # positions (jnp.take then read the padding tail and splitters
    # collapsed).  i*(ng//P) + (i*(ng%P))//P == (i*ng)//P exactly, with
    # every intermediate <= ng + P^2.
    ngc = jnp.maximum(ng, 1)
    i_ = jnp.arange(P_, dtype=jnp.int32)
    sample_pos = i_ * (ngc // jnp.int32(P_)) + (
        i_ * (ngc % jnp.int32(P_))
    ) // jnp.int32(P_)
    samples = jnp.take(h_sorted, sample_pos)
    samples = jnp.where(ng > 0, samples, HASH_PAD)
    cand = jnp.sort(lax.all_gather(samples, axis).reshape(-1))  # (P*P,)
    splitters = cand[jnp.arange(1, P_, dtype=jnp.int32) * P_]  # (P-1,)

    bounds = jnp.clip(
        jnp.searchsorted(h_sorted, splitters, side="left").astype(jnp.int32),
        0,
        ng,
    )
    send_bounds = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), bounds, ng[None].astype(jnp.int32)]
    )
    send_count = send_bounds[1:] - send_bounds[:-1]
    overflowed = jnp.any(send_count > capacity)

    def rows(buf, fill):
        padded = jnp.concatenate([buf, jnp.full((capacity,), fill, buf.dtype)])
        return send_windows(padded, send_bounds[:-1], capacity)

    send_keys = rows(uniq_s, jnp.zeros((), KEY_DTYPE))
    send_aggs = rows(agg_s, _identity(merge_op, agg_s.dtype))

    counts_mat = lax.all_gather(send_count, axis)  # (P, P): [i, c] = i -> c
    recv_count = counts_mat[:, my]  # (P,)
    recv_keys = lax.all_to_all(send_keys, axis, 0, 0, tiled=False)
    recv_aggs = lax.all_to_all(send_aggs, axis, 0, 0, tiled=False)

    # 4. final merge: same fused pack+combine sort as step 1+2 -----------
    k_iota = lax.broadcasted_iota(jnp.int32, (P_, capacity), 1)
    valid = (k_iota < recv_count[:, None]).reshape(-1)
    invalid = (~valid).astype(jnp.uint32)
    _, flat_keys, flat_aggs = lax.sort(
        (invalid, recv_keys.reshape(-1), recv_aggs.reshape(-1)),
        num_keys=2,
        is_stable=True,
    )
    total = valid.sum(dtype=jnp.int32)
    out_keys, out_aggs, out_ng = _combine_sorted(
        flat_keys, flat_aggs, total, merge_op
    )
    return (
        out_keys,
        out_aggs,
        out_ng[None].astype(jnp.int32),
        lax.psum(overflowed.astype(jnp.int32), axis),
    )


def build_hash_aggregate(
    mesh,
    n_local: int,
    *,
    op: str = "sum",
    predicate=None,
    capacity_factor: float = 2.0,
    axis: str = KEY_AXIS,
):
    """Compile-ready distributed group-by.

    Returns ``(fn, capacity)`` where ``fn(keys, values, row_valid) ->
    (group_keys, aggregates, ngroups_per_chip, overflow)``; inputs have
    global shape (P*n_local,) sharded over ``axis`` (``row_valid`` is bool —
    padding rows marked False never contribute); outputs are per-chip
    padded buffers of P*capacity rows plus valid counts.  For ``op="count"``
    values are ignored (pass keys).
    """
    if op not in VALID_AGG_OPS:
        raise ValueError(f"op must be one of {VALID_AGG_OPS}, got {op!r}")
    nchips = mesh.shape[axis]
    capacity = default_capacity(n_local, nchips, capacity_factor)

    fn = shard_map(
        lambda k, v, m: _pipeline_shard(
            k, v, m, axis=axis, capacity=capacity, op=op, predicate=predicate
        ),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P()),
    )
    return jax.jit(fn), capacity


def _predicate_cache_key(predicate):
    """Value-based cache key for a predicate: code object + closure cell
    values (+ defaults).  Two textually identical lambdas built on separate
    calls share a key, so callers passing a fresh ``lambda k: ...`` per call
    hit the cache instead of silently paying for a new compile.
    Falls back to object identity when closure values are unhashable."""
    if predicate is None:
        return None
    code = getattr(predicate, "__code__", None)
    if code is None:  # callables without __code__ (partials, objects)
        return predicate
    cells = getattr(predicate, "__closure__", None) or ()
    defaults = getattr(predicate, "__defaults__", None) or ()
    # unhashable closure values surface as TypeError at dict lookup, where
    # the caller falls back to rebuilding (no cache)
    return (code, tuple(c.cell_contents for c in cells), defaults)


_hash_aggregate_cache: dict = {}


def _cached_hash_aggregate(mesh, n_local, op, predicate, capacity_factor):
    key = (
        mesh, n_local, op, _predicate_cache_key(predicate), capacity_factor
    )
    try:
        return _hash_aggregate_cache[key]
    except (KeyError, TypeError):
        pass
    built = build_hash_aggregate(
        mesh, n_local, op=op, predicate=predicate,
        capacity_factor=capacity_factor,
    )
    try:
        _hash_aggregate_cache[key] = built
        if len(_hash_aggregate_cache) > 64:
            _hash_aggregate_cache.pop(next(iter(_hash_aggregate_cache)))
    except TypeError:  # unhashable key component: skip caching
        pass
    return built


def hash_aggregate_distributed(
    keys,
    values=None,
    *,
    op: str = "sum",
    predicate=None,
    mesh=None,
    capacity_factor: float = 2.0,
    key_order: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-facing distributed group-by: returns (group_keys, aggregates)
    over all chips — in hash order by default (the exchange's natural
    order), or ascending key order with ``key_order=True`` (one stable
    pair sort over the DISTINCT keys only, matching ``np.unique``'s
    presentation).  Raises on exchange overflow."""
    from .distributed import OverflowError_

    mesh = mesh or key_mesh()
    nchips = mesh.shape[KEY_AXIS]
    keys = np.asarray(keys, dtype=np.uint32)
    n = keys.size
    if values is None:
        if op != "count":
            raise ValueError("values required unless op='count'")
        values = keys  # ignored for count
    else:
        values = np.asarray(values)
    n_local = max(-(-n // nchips), nchips)
    n_pad = n_local * nchips

    pad_keys = np.zeros(n_pad, dtype=np.uint32)
    pad_keys[:n] = keys
    pad_vals = np.zeros(n_pad, dtype=values.dtype)
    pad_vals[:n] = values
    row_valid = np.zeros(n_pad, dtype=bool)
    row_valid[:n] = True

    sharding = NamedSharding(mesh, P(KEY_AXIS))
    dk = jax.device_put(pad_keys, sharding)
    dv = jax.device_put(pad_vals, sharding)
    dm = jax.device_put(row_valid, sharding)

    # cache the built+jitted program: rebuilding per call created a fresh
    # jit object every time, and so a new compile
    fn, capacity = _cached_hash_aggregate(
        mesh, n_local, op, predicate, capacity_factor
    )
    gk, ga, ng, overflow = (
        np.asarray(jax.device_get(x)) for x in fn(dk, dv, dm)
    )
    if int(overflow) > 0:
        raise OverflowError_(
            "hash-aggregate exchange capacity overflowed; raise capacity_factor"
        )
    rows_per_chip = gk.size // nchips
    out_k, out_a = [], []
    for c in range(nchips):
        cnt = int(ng[c])
        out_k.append(gk[c * rows_per_chip : c * rows_per_chip + cnt])
        out_a.append(ga[c * rows_per_chip : c * rows_per_chip + cnt])
    out_keys = np.concatenate(out_k) if out_k else np.empty(0, np.uint32)
    out_aggs = np.concatenate(out_a) if out_a else np.empty(0, values.dtype)
    if key_order and out_keys.size:
        # Group keys are globally DISTINCT (each chip owns disjoint hash
        # ranges and aggregates per unique key), so any pair sort is exact;
        # it runs over ngroups rows, not the n input rows.  Large group
        # counts ride the device pair-sort (ops/radix_sort.sort_key_value:
        # payload rides the sort as an operand); small ones stay on host
        # np.argsort, where a device round trip would cost more than the
        # sort.  Where the crossover lies on the GPU is not measured yet.
        if out_keys.size >= (1 << 16):
            from ..ops.radix_sort import sort_key_value

            sk, sv = sort_key_value(
                jnp.asarray(out_keys), jnp.asarray(out_aggs)
            )
            out_keys, out_aggs = np.asarray(sk), np.asarray(sv)
        else:
            order = np.argsort(out_keys)
            out_keys, out_aggs = out_keys[order], out_aggs[order]
    return out_keys, out_aggs
