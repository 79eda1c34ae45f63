"""Distributed hash-partition -> filter -> aggregate pipeline tests
(BASELINE.json config 5), on the 8-device virtual CPU mesh."""

import jax.numpy as jnp
import numpy as np
import pytest

from gpu_radix_sort_tpu.parallel.pipeline import hash_aggregate_distributed
from gpu_radix_sort_tpu.utils.keygen import Pcg32, generate_zipf_keys


def _oracle(keys, values, op, pred=None):
    keys = np.asarray(keys)
    if pred is not None:
        m = pred(keys)
        keys, values = keys[m], None if values is None else values[m]
    uk = np.unique(keys)
    if op == "count":
        agg = np.array([np.sum(keys == k) for k in uk])
    else:
        fn = {"sum": np.sum, "min": np.min, "max": np.max}[op]
        agg = np.array([fn(values[keys == k]) for k in uk])
    return uk, agg


def _sorted_by_key(gk, ga):
    order = np.argsort(gk, kind="stable")
    return gk[order], ga[order]


def test_count_zipf_skew():
    """The headline scenario: heavily duplicated Zipf keys; the local
    combiner must neutralize skew so the exchange never overflows."""
    keys = generate_zipf_keys(40_000, alpha=1.2, seed=5)
    gk, ga = hash_aggregate_distributed(keys, op="count")
    want_k, want_c = _oracle(keys, None, "count")
    gk, ga = _sorted_by_key(gk, ga)
    np.testing.assert_array_equal(gk, want_k)
    np.testing.assert_array_equal(ga.astype(np.int64), want_c)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_value_aggregates(op):
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 500, size=10_000).astype(np.uint32)
    vals = (rng.random(10_000) * 1000).astype(np.float32)
    gk, ga = hash_aggregate_distributed(keys, vals, op=op)
    want_k, want_a = _oracle(keys, vals, op)
    gk, ga = _sorted_by_key(gk, ga)
    np.testing.assert_array_equal(gk, want_k)
    if op == "sum":
        np.testing.assert_allclose(ga, want_a, rtol=1e-4)
    else:
        np.testing.assert_array_equal(ga, want_a)


def test_predicate_filter():
    keys = Pcg32().fill(20_000)
    vals = np.ones(keys.size, dtype=np.float32)
    pred_jax = lambda k: (k & jnp.uint32(1)) == 0  # even keys only
    pred_np = lambda k: (k & 1) == 0
    gk, ga = hash_aggregate_distributed(keys, vals, op="sum", predicate=pred_jax)
    want_k, want_a = _oracle(keys, vals, "sum", pred_np)
    gk, ga = _sorted_by_key(gk, ga)
    np.testing.assert_array_equal(gk, want_k)
    np.testing.assert_allclose(ga, want_a, rtol=1e-5)
    assert np.all(gk % 2 == 0)


def test_full_range_keys_no_sentinel_corruption():
    """Keys 0 and 0xFFFFFFFF are ordinary values — validity is tracked by
    packing, not sentinels."""
    keys = np.array(
        [0, 0xFFFFFFFF, 0, 0xFFFFFFFF, 42, 0xFFFFFFFF, 0] * 9, dtype=np.uint32
    )  # 63 rows: also exercises padding (not divisible by 8 chips)
    vals = np.arange(keys.size, dtype=np.float32)
    gk, ga = hash_aggregate_distributed(keys, vals, op="min")
    want_k, want_a = _oracle(keys, vals, "min")
    gk, ga = _sorted_by_key(gk, ga)
    np.testing.assert_array_equal(gk, want_k)
    np.testing.assert_array_equal(ga, want_a)


def test_padding_rows_do_not_contribute():
    keys = np.full(13, 7, dtype=np.uint32)  # 13 rows over 8 chips -> padding
    gk, ga = hash_aggregate_distributed(keys, op="count")
    assert gk.tolist() == [7]
    assert ga.tolist() == [13]


def test_all_filtered_out():
    keys = Pcg32().fill(1000)
    vals = np.ones(1000, dtype=np.float32)
    gk, ga = hash_aggregate_distributed(
        keys, vals, op="sum", predicate=lambda k: k < jnp.uint32(0)
    )
    assert gk.size == 0 and ga.size == 0


def test_values_required_unless_count():
    with pytest.raises(ValueError, match="values required"):
        hash_aggregate_distributed(np.zeros(8, np.uint32), op="sum")


def test_predicate_cache_hits_on_fresh_lambdas():
    """Two textually identical lambdas (same code, same closure values)
    must share one compiled program — callers passing a fresh lambda per
    call must not silently pay for a new compile each time."""
    from gpu_radix_sort_tpu.parallel import pipeline as pl_mod

    def make(threshold):
        return lambda k: k < jnp.uint32(threshold)

    k1 = pl_mod._predicate_cache_key(make(100))
    k2 = pl_mod._predicate_cache_key(make(100))
    assert k1 == k2 and hash(k1) == hash(k2)
    # different closure values must NOT collide
    assert pl_mod._predicate_cache_key(make(200)) != k1

    pl_mod._hash_aggregate_cache.clear()
    keys = Pcg32().fill(256)
    vals = np.ones(256, dtype=np.float32)
    hash_aggregate_distributed(keys, vals, op="sum", predicate=make(1 << 31))
    assert len(pl_mod._hash_aggregate_cache) == 1
    hash_aggregate_distributed(keys, vals, op="sum", predicate=make(1 << 31))
    assert len(pl_mod._hash_aggregate_cache) == 1  # cache hit, no rebuild


def test_predicate_cache_none_and_unhashable():
    from gpu_radix_sort_tpu.parallel import pipeline as pl_mod

    assert pl_mod._predicate_cache_key(None) is None
    unhash = [jnp.uint32(5)]
    pred = lambda k: k < unhash[0]  # noqa: E731 — closure over a list
    # unhashable closure cell -> lookup falls back to rebuild (no crash)
    keys = Pcg32().fill(64)
    vals = np.ones(64, dtype=np.float32)
    gk, ga = hash_aggregate_distributed(keys, vals, op="sum", predicate=pred)
    assert gk.size == ga.size


def test_key_order_flag_matches_np_unique():
    """key_order=True returns groups in ascending key order directly
    (VERDICT r3 item 10) — np.unique IS the oracle, no re-sort."""
    keys = generate_zipf_keys(30_000, alpha=1.3, seed=9)
    gk, ga = hash_aggregate_distributed(keys, op="count", key_order=True)
    want_k, want_c = np.unique(keys, return_counts=True)
    np.testing.assert_array_equal(gk, want_k)
    np.testing.assert_array_equal(ga.astype(np.int64), want_c)


def test_key_order_flag_value_op():
    rng = np.random.default_rng(31)
    keys = rng.integers(0, 300, size=5_000).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, size=5_000).astype(np.uint32)
    gk, ga = hash_aggregate_distributed(
        keys, vals, op="max", key_order=True
    )
    want_k, want_a = _oracle(keys, vals, "max")
    np.testing.assert_array_equal(gk, want_k)
    np.testing.assert_array_equal(ga, want_a)


def test_key_order_device_sort_1m_distinct():
    """key_order's distinct-key sort runs ON DEVICE (sort_key_value pair
    sort, VERDICT r4 item 9) — exercised at >= 1M distinct group keys,
    where the old host np.argsort was the scaling liability."""
    n_distinct = 1_050_000
    # odd multiplier mod 2^32 is a bijection -> all keys distinct
    base = (
        np.arange(n_distinct, dtype=np.uint64) * np.uint64(2654435761)
    ).astype(np.uint32)
    keys = np.concatenate([base, base[:1000]])  # 1000 keys with count 2
    gk, ga = hash_aggregate_distributed(keys, op="count", key_order=True)
    want_k, want_c = np.unique(keys, return_counts=True)
    assert want_k.size == n_distinct
    np.testing.assert_array_equal(gk, want_k)
    np.testing.assert_array_equal(ga.astype(np.int64), want_c)
