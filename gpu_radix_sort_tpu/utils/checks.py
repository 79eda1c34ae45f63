"""Correctness oracles, mirroring the reference's layered exact-match checks.

Reference analogs:
  * ``check_sorted`` / ``check_sort_full`` — localTest/tests.cpp:88-161
    (monotonicity + exact compare vs CPU std::sort) and
    faasTest/pylibsort/sort.py:50-66 (vs Python sorted()).
  * ``check_partial`` — faasTest/pylibsort/sort.py:67-91 and the Go
    ``checkPartial`` (benchmark/pkg/sort/testHelpers.go:324-448): digit
    groups in order, multiset preserved; we additionally assert stability,
    which the reference's LSD passes guarantee implicitly.
  * ``boundaries_oracle`` — the CPU histogram oracle of
    localTest/tests.cpp:38-86, extended to reproduce the *exact* boundary
    contract of SortState::GetBoundaries (sort.cu:367-394), quirks included.

All functions are numpy-only so they can validate the JAX/XLA paths and
the native CPU oracle against one another.
"""

from __future__ import annotations

import numpy as np


def extract_digits(keys: np.ndarray, offset: int, width: int) -> np.ndarray:
    """bits [offset, offset+width) of each key (reference: sort.cu:9
    ``group_bits``)."""
    if not (0 < width <= 32 and 0 <= offset and offset + width <= 32):
        raise ValueError(f"invalid digit range offset={offset} width={width}")
    mask = np.uint32(0xFFFFFFFF) if width == 32 else np.uint32((1 << width) - 1)
    return (keys.astype(np.uint32) >> np.uint32(offset)) & mask


def check_sorted(keys: np.ndarray) -> bool:
    """Monotone nondecreasing (reference: localTest tests `checkSort`)."""
    keys = np.asarray(keys)
    return bool(np.all(keys[:-1] <= keys[1:])) if keys.size > 1 else True


def check_sort_full(result: np.ndarray, original: np.ndarray) -> bool:
    """Exact bitwise match against the CPU oracle sort."""
    result = np.asarray(result, dtype=np.uint32)
    expected = np.sort(np.asarray(original, dtype=np.uint32), kind="stable")
    return result.shape == expected.shape and bool(np.array_equal(result, expected))


def partial_sort_oracle(
    original: np.ndarray, offset: int, width: int
) -> np.ndarray:
    """Expected output of a *stable* partial sort by bits
    [offset, offset+width) — the net effect of the reference's LSD 2-bit
    passes (sort.cu:322-346)."""
    original = np.asarray(original, dtype=np.uint32)
    digits = extract_digits(original, offset, width)
    order = np.argsort(digits, kind="stable")
    return original[order]


def check_partial(
    result: np.ndarray, original: np.ndarray, offset: int, width: int
) -> bool:
    """Exact match against the stable partial-sort oracle (stronger than the
    reference's group-membership check, which our stable implementations
    must also satisfy)."""
    expected = partial_sort_oracle(original, offset, width)
    result = np.asarray(result, dtype=np.uint32)
    return result.shape == expected.shape and bool(np.array_equal(result, expected))


def check_partial_groups(
    result: np.ndarray, original: np.ndarray, offset: int, width: int
) -> bool:
    """The reference's own partial-sort contract, strengthened to full
    multiset equality: digit groups ascending with the reference's exact
    group sizes (faasTest/pylibsort/sort.py:67-91 ``checkPartial`` /
    benchmark/pkg/sort/testHelpers.go:324-448) AND the key multiset
    preserved (the reference's membership assert, which it ships disabled
    as too slow, done properly via one sort).  The contract of
    ``sort_partial(..., stable=False)``."""
    result = np.asarray(result, dtype=np.uint32)
    original = np.asarray(original, dtype=np.uint32)
    if result.shape != original.shape:
        return False
    got_digits = extract_digits(result, offset, width)
    counts = np.bincount(
        extract_digits(original, offset, width), minlength=1 << width
    )
    expect_digits = np.repeat(np.arange(1 << width, dtype=np.uint32), counts)
    if not np.array_equal(got_digits, expect_digits):
        return False
    return bool(np.array_equal(np.sort(result), np.sort(original)))


def boundaries_oracle(
    sorted_keys: np.ndarray, offset: int, width: int
) -> np.ndarray:
    """Reference-contract group boundaries for digit-sorted input.

    Reproduces SortState::GetBoundaries (sort.cu:367-394) exactly:
      * boundaries[g] = first index i>0 where the digit changes to g
        (gpu_groups, sort.cu:14-27); the group of element 0 is NOT marked,
        so boundaries[digit(keys[0])] stays 0 — correct only when that
        digit's run starts at 0, which holds for digit-sorted input of the
        smallest present digit.
      * empty-group backfill high->low for groups > 1 (sort.cu:381-387),
        seeded with len(keys); a zero boundaries[1] is never backfilled.
    """
    sorted_keys = np.asarray(sorted_keys, dtype=np.uint32)
    nb = 1 << width
    b = np.zeros(nb, dtype=np.uint32)
    if sorted_keys.size:
        d = extract_digits(sorted_keys, offset, width)
        change = np.nonzero(d[1:] != d[:-1])[0] + 1
        b[d[change]] = change.astype(np.uint32)
    prev = np.uint32(sorted_keys.size)
    for g in range(nb - 1, 1, -1):
        if b[g] == 0:
            b[g] = prev
        prev = b[g]
    return b


def true_bucket_counts(keys: np.ndarray, offset: int, width: int) -> np.ndarray:
    """Exact per-digit counts (histogram), the bucket metadata
    that replaces boundary scans in the distributed path."""
    d = extract_digits(np.asarray(keys, dtype=np.uint32), offset, width)
    return np.bincount(d, minlength=1 << width).astype(np.int64)


def bucket_counts_from_boundaries(
    boundaries: np.ndarray, n: int
) -> np.ndarray:
    """Bucket sizes the reference derives from boundaries
    (benchmark/pkg/sort/distrib.go:45-53): sizes[i] = b[i+1]-b[i],
    last = n - b[last]."""
    b = np.asarray(boundaries, dtype=np.int64)
    sizes = np.empty_like(b)
    sizes[:-1] = b[1:] - b[:-1]
    sizes[-1] = n - b[-1]
    return sizes
