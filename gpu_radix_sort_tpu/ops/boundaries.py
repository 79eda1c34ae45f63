"""Group-boundary detection over digit-sorted keys.

TPU-native re-design of the reference's boundary machinery
(gpu_groups kernel, libsort/sort.cu:14-27, plus the host-side empty-group
backfill in SortState::GetBoundaries, sort.cu:367-394): instead of a
one-thread-per-element kernel followed by a host loop, the change-point
scatter and the backfill both run as O(2^width) vectorized device ops (the
backfill is an associative suffix scan), so boundaries never leave the
device — bucket metadata stays a device array rather than JSON, the
explicit design goal recorded in SURVEY.md §6.

Two contracts are provided:
  * :func:`compute_boundaries` — bit-exact with the reference (including its
    quirks: the group of element 0 is never marked and group 1 is never
    backfilled), for API/test parity.
  * :func:`digit_counts` — exact per-digit histogram, the metadata the
    distributed path actually uses (immune to the reference's
    empty-group-0/1 edge cases).
"""

from __future__ import annotations

import jax.numpy as jnp

from .bits import KEY_DTYPE, extract_digits, validate_digit_range


def true_group_starts(
    sorted_keys: jnp.ndarray, offset: int, width: int
) -> jnp.ndarray:
    """s[g] = first index where group g would start, for g in 0..2^width
    (s[2^width] = n).  Exact start positions via binary search — O(D log n),
    no scatter."""
    validate_digit_range(offset, width)
    nb = 1 << width
    d = extract_digits(sorted_keys, offset, width)
    queries = jnp.arange(nb + 1, dtype=KEY_DTYPE)
    return jnp.searchsorted(d, queries, side="left").astype(KEY_DTYPE)


def compute_boundaries(
    sorted_keys: jnp.ndarray, offset: int, width: int
) -> jnp.ndarray:
    """Reference-contract boundaries of each digit group (uint32[2^width]).

    Input must already be sorted by bits [offset, offset+width).
    Matches SortState::GetBoundaries (sort.cu:367-394) bitwise, including
    its two quirks (gpu_groups never marks element 0's group, and the
    high->low backfill skips group 1):

      * groups in [2, d[0]] report the start of the group *after* d[0]
        (when d[0] >= 2 the reference "loses" element 0's run);
      * an empty group 1 reports 0 instead of its true start;
      * all other groups report their true start (searchsorted), with
        empty groups naturally equal to the next group's start — exactly
        what the reference backfill computes.

    Derived scatter-free from true starts; cross-validated against the
    direct backfill transcription in tests.
    """
    validate_digit_range(offset, width)
    nb = 1 << width
    n = sorted_keys.shape[0]
    if n == 0:
        return jnp.zeros(nb, dtype=KEY_DTYPE)

    s = true_group_starts(sorted_keys, offset, width)  # (nb+1,)
    b = s[:nb]
    g = jnp.arange(nb, dtype=KEY_DTYPE)
    g0 = extract_digits(sorted_keys[:1], offset, width)[0]
    # Quirk 1: element 0's group is never marked; if g0 >= 2 the backfill
    # overwrites groups [2, g0] with the next group's start.
    b = jnp.where((g >= 2) & (g <= g0), s[g0 + 1], b)
    # Quirk 2: an empty group 1 is never backfilled.
    group1_present = s[2] > s[1]
    b = jnp.where((g == 1) & ~group1_present, jnp.uint32(0), b)
    return b


def digit_counts(keys: jnp.ndarray, offset: int, width: int) -> jnp.ndarray:
    """Exact per-digit counts (int32[2^width]).  The bucket
    metadata used by the distributed exchange; replaces
    boundaries->sizes derivation (benchmark/pkg/sort/distrib.go:45-53)."""
    validate_digit_range(offset, width)
    d = extract_digits(keys, offset, width)
    return jnp.bincount(d, length=1 << width).astype(jnp.int32)


def digit_counts_sorted(
    sorted_keys: jnp.ndarray, offset: int, width: int
) -> jnp.ndarray:
    """Per-digit counts of already-digit-sorted keys via searchsorted diff —
    scatter-free (bincount lowers to a scatter-add)."""
    s = true_group_starts(sorted_keys, offset, width)
    return (s[1:] - s[:-1]).astype(jnp.int32)


def counts_to_boundaries(counts: jnp.ndarray) -> jnp.ndarray:
    """Exclusive prefix sum of counts = true start index of each digit group
    (the histogram-derived oracle of localTest/tests.cpp:44-55)."""
    return jnp.concatenate(
        [jnp.zeros(1, counts.dtype), jnp.cumsum(counts)[:-1]]
    )
