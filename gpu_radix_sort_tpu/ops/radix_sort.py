"""Single-chip sort core: full and partial radix sort over uint32 keys.

Capability mirror of the reference C ABI (libsort/invokers.cu):
  * :func:`sort_full`     — ``providedGpu`` (invokers.cu:45): ascending full
    sort of uint32 keys.
  * :func:`sort_partial`  — ``gpuPartial`` (invokers.cu:15): stable sort by
    bits [offset, offset+width) plus reference-contract group boundaries
    (sort.cu:367-394).  The reference realizes width as width/2 two-bit LSD
    passes — a GPU shared-memory artifact; digit width per pass here is an
    implementation detail of the strategy.

Strategies (selected per call or via set_default_strategy):
  * ``"xla"``  — XLA's native sort (lax.sort / lax.sort_key_val).  On a GPU,
    XLA hands one-operand sorts and plain key+value pair sorts to CUB's
    radix sort; other sorts run XLA's own sort kernel.
  * ``"auto"`` — the default; today the same as ``"xla"``.  It is the hook
    a hand-written kernel would be chosen through once one beats XLA.

All entry points are pure functions safe under jit/vmap/shard_map; nothing
here reserves devices (the reference's semaphore+CAS device reservation,
libsort/utils.cu:34-61, is unnecessary under JAX's single-owner runtime).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .bits import KEY_DTYPE, extract_digits, validate_digit_range
from .boundaries import compute_boundaries

_DEFAULT_STRATEGY = "auto"
_VALID = ("auto", "xla")
# Strategy names of removed kernels: asking for one is an error, never a
# silent fallback to another engine.
REMOVED_STRATEGIES = ("pallas", "pallas_merge", "pallas_radix")

# Payload lanes up to this many ride XLA sorts as extra operands; wider
# payloads are permuted by rank-keyed lane-group sorts.  Which of the two
# (or a plain gather) is fastest on the GPU is not measured yet.
MAX_SORT_LANES = 4


def check_strategy(name: str | None) -> str:
    """``name`` (None = the default) if it is a valid strategy, else a
    ValueError that says whether it names a removed kernel."""
    name = name or _DEFAULT_STRATEGY
    if name in REMOVED_STRATEGIES:
        raise ValueError(
            f"strategy {name!r} named a Pallas kernel that has been removed; "
            f"use one of {_VALID}"
        )
    if name not in _VALID:
        raise ValueError(f"strategy must be one of {_VALID}, got {name!r}")
    return name


def _lanes_view(values: jnp.ndarray) -> jnp.ndarray | None:
    """``values`` as (n, W) uint32 lanes when cheaply possible, else None.

    Accepts (n, W) 4-byte-dtype lanes and (n, B) uint8 rows with B % 4 == 0
    (bitcast, no data movement)."""
    if values.ndim != 2:
        return None
    if values.dtype.itemsize == 4:
        return jax.lax.bitcast_convert_type(values, jnp.uint32)
    if values.dtype == jnp.uint8 and values.shape[1] % 4 == 0:
        return jax.lax.bitcast_convert_type(
            values.reshape(values.shape[0], -1, 4), jnp.uint32
        )
    return None


def _lanes_restore(lanes: jnp.ndarray, like: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`_lanes_view` for the sorted lanes."""
    if like.dtype.itemsize == 4:
        out = lanes
        if like.dtype != jnp.uint32:
            out = jax.lax.bitcast_convert_type(lanes, like.dtype)
        return out
    return jax.lax.bitcast_convert_type(lanes, jnp.uint8).reshape(like.shape)


def _permute_lanes_grouped(
    rank: jnp.ndarray, lanes: jnp.ndarray
) -> jnp.ndarray:
    """Apply a permutation to (n, W) uint32 lanes via grouped lane-riding
    sorts: lane groups of MAX_SORT_LANES ride ``lax.sort`` keyed by each
    row's destination rank.  ``rank`` must be a permutation of [0, n)
    (all-distinct keys, so an unstable sort is exact).  For W lanes the
    cost is ceil(W/4) sorts instead of an n*W-element gather."""
    out_cols: list[jnp.ndarray] = []
    for g0 in range(0, lanes.shape[1], MAX_SORT_LANES):
        cols = tuple(
            lanes[:, w]
            for w in range(g0, min(g0 + MAX_SORT_LANES, lanes.shape[1]))
        )
        sorted_ops = jax.lax.sort((rank, *cols), num_keys=1, is_stable=False)
        out_cols.extend(sorted_ops[1:])
    return jnp.stack(out_cols, axis=1)


def _invert_permutation(order: jnp.ndarray) -> jnp.ndarray:
    """rank[j] = position of j in ``order``: one scatter with unique
    indices.  (XLA's GPU compiler rewrites the equivalent sort of
    (order, iota) into this scatter, and with uint32 operands the rewrite
    fails its own HLO verifier.)"""
    n = order.shape[0]
    iota = jnp.arange(n, dtype=jnp.uint32)
    return jnp.zeros(n, jnp.uint32).at[order].set(
        iota, unique_indices=True, mode="promise_in_bounds"
    )


def set_default_strategy(name: str) -> None:
    global _DEFAULT_STRATEGY
    _DEFAULT_STRATEGY = check_strategy(name)


def get_default_strategy() -> str:
    return _DEFAULT_STRATEGY


# ---------------------------------------------------------------------------
# XLA strategy
# ---------------------------------------------------------------------------

def _sort_full_xla(keys: jnp.ndarray) -> jnp.ndarray:
    return jnp.sort(keys.astype(KEY_DTYPE))


def _narrow_digits(digits: jnp.ndarray, width: int) -> jnp.ndarray:
    """Digit keys in the narrowest unsigned type that holds ``width`` bits:
    a u8/u16 sort key moves fewer bytes per radix pass and per compare."""
    if width <= 8:
        return digits.astype(jnp.uint8)
    if width <= 16:
        return digits.astype(jnp.uint16)
    return digits


def _sort_partial_xla(keys: jnp.ndarray, offset: int, width: int) -> jnp.ndarray:
    digits = _narrow_digits(extract_digits(keys, offset, width), width)
    _, sorted_keys = jax.lax.sort_key_val(
        digits, keys.astype(KEY_DTYPE), is_stable=True
    )
    return sorted_keys


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def sort_full(keys: jnp.ndarray, *, strategy: str | None = None) -> jnp.ndarray:
    """Ascending full sort of uint32 keys (reference: invokers.cu:45).

    int32 / float32 keys are accepted via the order-preserving uint32
    bijection (:func:`ops.bits.encode_ordered` — IEEE-754 total order for
    floats, beyond the reference's uint32-only surface)."""
    keys = jnp.asarray(keys)
    if keys.dtype in (jnp.int32, jnp.float32):
        from .bits import decode_ordered, encode_ordered

        return decode_ordered(
            sort_full(encode_ordered(keys), strategy=strategy), keys.dtype
        )
    check_strategy(strategy)
    return _sort_full_xla(keys)


def _sort_by_digits_rotated(
    keys: jnp.ndarray, offset: int, width: int, strategy: str | None
) -> jnp.ndarray:
    """Reference-contract (non-stable) digit sort: rotate the word so the
    digit occupies the top bits, run a keys-only FULL sort, rotate back.

    The result has exact digit groups in ascending order with the key
    multiset preserved — precisely what the reference itself checks
    (faasTest/pylibsort/sort.py:67-91 ``checkPartial`` and the Go
    ``checkPartial``, benchmark/pkg/sort/testHelpers.go:324-448: group
    membership only; its element-membership assert is even disabled as too
    slow).  Within a digit group the order is the ROTATED-VALUE order
    (deterministic, value-pure), not the input order — the same
    rotated-value identity the fused LSD rounds ride
    (parallel/distributed._fused_sort_shard).  It is offered because a
    keys-only full sort moves fewer bytes than a stable digit pair sort.
    """
    from .bits import rotr32

    s = (offset + width) % 32
    z = sort_full(rotr32(keys.astype(KEY_DTYPE), s), strategy=strategy)
    return rotr32(z, (32 - s) % 32)


def sort_by_digits(
    keys: jnp.ndarray, offset: int, width: int, *, strategy: str | None = None,
    stable: bool = True,
) -> jnp.ndarray:
    """Sort by bits [offset, offset+width) — the partial sort's data
    movement without boundary extraction.

    ``stable=True`` (default): stable by input order within equal digits —
    the LSD-composability contract the distributed planes depend on.
    ``stable=False``: the reference's checked contract only (digit groups
    in order, multiset preserved; within-group order is the deterministic
    rotated-value order) via a keys-only full sort of the digit-rotated
    word — see :func:`_sort_by_digits_rotated`."""
    validate_digit_range(offset, width)
    check_strategy(strategy)
    if not stable:
        return _sort_by_digits_rotated(keys, offset, width, strategy)
    return _sort_partial_xla(keys, offset, width)


def sort_partial(
    keys: jnp.ndarray, offset: int, width: int, *, strategy: str | None = None,
    stable: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Partial sort + reference-contract boundaries.

    Returns ``(sorted_keys, boundaries)`` where boundaries is
    uint32[2^width] with the exact semantics of the reference C ABI
    (invokers.cu:15 + sort.cu:367-394, empty-group backfill included).
    ``stable=False`` relaxes within-group order to the reference's own
    checked contract (see :func:`sort_by_digits`);
    boundaries are order-independent, so they are identical either way.
    """
    sorted_keys = sort_by_digits(
        keys, offset, width, strategy=strategy, stable=stable
    )
    boundaries = compute_boundaries(sorted_keys, offset, width)
    return sorted_keys, boundaries


def sort_partial_counts(
    keys: jnp.ndarray, offset: int, width: int, *, strategy: str | None = None,
    stable: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Partial sort + exact per-digit counts (int32[2^width]).

    Variant used by the distributed path: counts come from the
    histogram, avoiding the reference boundary contract's empty-group-0/1
    quirks and keeping bucket metadata exact.  ``stable`` as in
    :func:`sort_partial`.
    """
    validate_digit_range(offset, width)
    sorted_keys = sort_by_digits(
        keys, offset, width, strategy=strategy, stable=stable
    )
    # counts from the sorted runs (searchsorted diffs) — no scatter.
    from .boundaries import digit_counts_sorted

    return sorted_keys, digit_counts_sorted(sorted_keys, offset, width)


def sort_key_value(
    keys: jnp.ndarray,
    values: jnp.ndarray,
    *,
    strategy: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Stable ascending full sort of (key, value) rows.

    Stability gives deterministic payload placement for duplicate keys —
    the "stable payload placement" requirement of BASELINE.json.  ``values``
    may be any dtype/shape with leading axis == len(keys); multi-byte
    payloads ride along via a rank gather.  int32 / float32 keys are
    accepted via the order-preserving uint32 bijection (ops/bits.py).
    """
    keys = jnp.asarray(keys)
    if keys.dtype in (jnp.int32, jnp.float32):
        from .bits import decode_ordered, encode_ordered

        sk, sv = sort_key_value(
            encode_ordered(keys), values, strategy=strategy
        )
        return decode_ordered(sk, keys.dtype), sv
    check_strategy(strategy)
    keys = keys.astype(KEY_DTYPE)
    if values.shape[0] != keys.shape[0]:
        raise ValueError(
            f"values leading axis {values.shape[0]} != len(keys) {keys.shape[0]}"
        )
    if values.ndim == 1 and values.dtype.itemsize <= 4:
        sorted_keys, sorted_vals = jax.lax.sort_key_val(
            keys, values, is_stable=True
        )
        return sorted_keys, sorted_vals
    # Payloads up to MAX_SORT_LANES uint32 lanes ride the sort as extra
    # operands: the sort moves whole rows, with no permutation gather.
    lanes = _lanes_view(values)
    if lanes is not None and 0 < lanes.shape[1] <= MAX_SORT_LANES:
        cols = tuple(lanes[:, w] for w in range(lanes.shape[1]))
        sorted_ops = jax.lax.sort((keys, *cols), num_keys=1, is_stable=True)
        out_lanes = jnp.stack(sorted_ops[1:], axis=1)
        return sorted_ops[0], _lanes_restore(out_lanes, values)
    # Wide payloads: sort (key, row-index) once for the order, invert it,
    # then move payload lanes in groups of MAX_SORT_LANES keyed by each
    # row's destination rank.  Non-bitcastable payloads keep the gather.
    idx = jnp.arange(keys.shape[0], dtype=jnp.uint32)
    sorted_keys, order = jax.lax.sort_key_val(keys, idx, is_stable=True)
    if lanes is not None and lanes.shape[1] > 0:
        rank = _invert_permutation(order)
        out_lanes = _permute_lanes_grouped(rank, lanes)
        return sorted_keys, _lanes_restore(out_lanes, values)
    return sorted_keys, jnp.take(values, order, axis=0)


def sort_key_value_by_digits(
    keys: jnp.ndarray,
    values: jnp.ndarray,
    offset: int,
    width: int,
    *,
    strategy: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Stable partial (digit) sort of (key, value) rows.  Narrow payloads
    ride the digit sort as operands (see :func:`sort_key_value`)."""
    validate_digit_range(offset, width)
    check_strategy(strategy)
    keys = keys.astype(KEY_DTYPE)
    digits = _narrow_digits(extract_digits(keys, offset, width), width)
    if values.ndim == 1 and values.dtype.itemsize <= 4:
        _, sk, sv = jax.lax.sort((digits, keys, values), num_keys=1,
                                 is_stable=True)
        return sk, sv
    lanes = _lanes_view(values)
    if lanes is not None and 0 < lanes.shape[1] <= MAX_SORT_LANES:
        cols = tuple(lanes[:, w] for w in range(lanes.shape[1]))
        sorted_ops = jax.lax.sort(
            (digits, keys, *cols), num_keys=1, is_stable=True
        )
        out_lanes = jnp.stack(sorted_ops[2:], axis=1)
        return sorted_ops[1], _lanes_restore(out_lanes, values)
    idx = jnp.arange(keys.shape[0], dtype=jnp.uint32)
    _, sorted_keys, order = jax.lax.sort(
        (digits, keys, idx), num_keys=1, is_stable=True
    )
    if lanes is not None and lanes.shape[1] > 0:
        rank = _invert_permutation(order)
        out_lanes = _permute_lanes_grouped(rank, lanes)
        return sorted_keys, _lanes_restore(out_lanes, values)
    return sorted_keys, jnp.take(values, order, axis=0)


def sort_full_u64(keys) -> "np.ndarray":
    """Ascending full sort of 64-bit keys (uint64 / int64 / float64, the
    float64 order being IEEE-754 totalOrder) — beyond the reference's
    uint32-only surface (libsort.h:19).

    Host-facing: the key is split into (hi, lo) uint32 words and sorted by
    ONE lexicographic 2-lane sort on device (``lax.sort num_keys=2`` —
    half the work of the earlier two-stable-kv-pass LSD composition),
    then reassembled host-side.  No jax_enable_x64 required.
    """
    import numpy as np

    from .bits import decode_ordered_np64, encode_ordered_np64

    keys = np.asarray(keys)
    if keys.dtype not in (np.uint64, np.int64, np.float64):
        raise TypeError(
            f"sort_full_u64 takes uint64/int64/float64 keys, got {keys.dtype}"
        )
    enc = encode_ordered_np64(keys)
    lo = (enc & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (enc >> np.uint64(32)).astype(np.uint32)

    shi, slo = jax.jit(
        lambda h, l: jax.lax.sort((h, l), num_keys=2)
    )(jnp.asarray(hi), jnp.asarray(lo))
    out = (
        np.asarray(shi).astype(np.uint64) << np.uint64(32)
    ) | np.asarray(slo).astype(np.uint64)
    return decode_ordered_np64(out, keys.dtype)


def sort_key_value_u64(keys, values) -> tuple:
    """Stable ascending full sort of rows keyed by 64-BIT keys (uint64 /
    int64 / float64 totalOrder) — the single-chip twin of
    :func:`parallel.sample_sort.sort_key_value_distributed_64` and the kv
    extension of :func:`sort_full_u64`, beyond the reference's
    uint32-only surface (libsort.h:19).

    Host-facing: keys split into (hi, lo) uint32 word lanes; narrow
    payloads ride one stable ``lax.sort num_keys=2`` as extra operands,
    wide payloads move via rank-keyed grouped lane sorts (same policy as
    :func:`sort_key_value`).  ``values`` may be any dtype/shape with
    leading axis == len(keys).
    """
    import numpy as np

    from .bits import decode_ordered_np64, encode_ordered_np64

    keys = np.asarray(keys)
    if keys.dtype not in (np.uint64, np.int64, np.float64):
        raise TypeError(
            f"sort_key_value_u64 takes uint64/int64/float64 keys, got "
            f"{keys.dtype}"
        )
    values = np.asarray(values)
    if values.shape[0] != keys.shape[0]:
        raise ValueError(
            f"values leading axis {values.shape[0]} != len(keys) {keys.size}"
        )
    enc = encode_ordered_np64(keys)
    lo = jnp.asarray((enc & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((enc >> np.uint64(32)).astype(np.uint32))

    vals_j = jnp.asarray(values)
    lanes = _lanes_view(vals_j) if vals_j.ndim == 2 else None
    if vals_j.ndim == 1 and vals_j.dtype.itemsize <= 4:
        shi, slo, sv = jax.lax.sort(
            (hi, lo, vals_j), num_keys=2, is_stable=True
        )
        out_v = np.asarray(sv)
    elif lanes is not None and 0 < lanes.shape[1] <= MAX_SORT_LANES:
        cols = tuple(lanes[:, w] for w in range(lanes.shape[1]))
        sorted_ops = jax.lax.sort((hi, lo, *cols), num_keys=2, is_stable=True)
        shi, slo = sorted_ops[0], sorted_ops[1]
        out_v = np.asarray(
            _lanes_restore(jnp.stack(sorted_ops[2:], axis=1), vals_j)
        )
    else:
        idx = jnp.arange(hi.shape[0], dtype=jnp.uint32)
        shi, slo, order = jax.lax.sort((hi, lo, idx), num_keys=2,
                                       is_stable=True)
        if lanes is not None and lanes.shape[1] > 0:
            rank = _invert_permutation(order)
            out_v = np.asarray(
                _lanes_restore(_permute_lanes_grouped(rank, lanes), vals_j)
            )
        else:
            out_v = np.asarray(jnp.take(vals_j, order, axis=0))
    out64 = (
        np.asarray(shi).astype(np.uint64) << np.uint64(32)
    ) | np.asarray(slo).astype(np.uint64)
    return decode_ordered_np64(out64, keys.dtype), out_v


def _validate_digit_range_64(offset: int, width: int) -> None:
    if not (0 < width <= 32 and 0 <= offset and offset + width <= 64):
        raise ValueError(
            f"64-bit digit range [offset={offset}, offset+width="
            f"{offset + width}) must lie within [0, 64] with 1 <= width <= 32"
        )


def _sort_partial_u64_impl(keys, offset: int, width: int, stable: bool):
    """Shared digit-sort core for the 64-bit partial surfaces: returns the
    sorted encoded (hi, lo) word lanes plus the sorted digit lane (uint32,
    device array) from which boundaries/counts derive."""
    import numpy as np

    from .bits import encode_ordered_np64

    _validate_digit_range_64(offset, width)
    keys = np.asarray(keys)
    if keys.dtype not in (np.uint64, np.int64, np.float64):
        raise TypeError(
            f"64-bit partial sorts take uint64/int64/float64 keys, got "
            f"{keys.dtype}"
        )
    enc = encode_ordered_np64(keys)
    if stable:
        # stable-by-input-order within equal digits: one stable 1-key sort
        # carrying the (hi, lo) words as operands — the 64-bit twin of
        # sort_by_digits(stable=True) (reference contract: invokers.cu:15).
        digit = (
            (enc >> np.uint64(offset)) & np.uint64((1 << width) - 1)
        ).astype(np.uint32)
        lo = (enc & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (enc >> np.uint64(32)).astype(np.uint32)
        sd, shi, slo = jax.jit(
            lambda d, h, l: jax.lax.sort((d, h, l), num_keys=1,
                                         is_stable=True)
        )(jnp.asarray(digit), jnp.asarray(hi), jnp.asarray(lo))
        return shi, slo, sd
    # reference-checked contract (digit groups only): rotate the encoded
    # word so the digit occupies the top bits, keys-only lexicographic
    # 2-lane sort, rotate back — _sort_by_digits_rotated lifted to 64 bits.
    s = (offset + width) % 64
    if s:
        rot = (enc >> np.uint64(s)) | (enc << np.uint64(64 - s))
    else:
        rot = enc
    lo = (rot & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (rot >> np.uint64(32)).astype(np.uint32)
    rhi, rlo = jax.jit(
        lambda h, l: jax.lax.sort((h, l), num_keys=2)
    )(jnp.asarray(hi), jnp.asarray(lo))
    # digit now sits in the top `width` bits of the rotated word = top of hi
    sd = (rhi >> np.uint32(32 - width)) if width < 32 else rhi
    if s:
        # rotate back on the word lanes: out = rotl64(rot_sorted, s)
        if s < 32:
            shi = (rhi << np.uint32(s)) | (rlo >> np.uint32(32 - s))
            slo = (rlo << np.uint32(s)) | (rhi >> np.uint32(32 - s))
        elif s == 32:
            shi, slo = rlo, rhi
        else:
            t = s - 32
            shi = (rlo << np.uint32(t)) | (rhi >> np.uint32(32 - t))
            slo = (rhi << np.uint32(t)) | (rlo >> np.uint32(32 - t))
    else:
        shi, slo = rhi, rlo
    return shi, slo, sd


def _words_to_np64(shi, slo, dtype):
    import numpy as np

    from .bits import decode_ordered_np64

    out = (
        np.asarray(shi).astype(np.uint64) << np.uint64(32)
    ) | np.asarray(slo).astype(np.uint64)
    return decode_ordered_np64(out, dtype)


def sort_partial_u64(
    keys, offset: int, width: int, *, stable: bool = True
) -> tuple:
    """Partial sort + reference-contract boundaries for 64-BIT keys
    (uint64 / int64 / float64 totalOrder) — the 64-bit twin of
    :func:`sort_partial`, beyond the reference's uint32-only C ABI
    (libsort.h:19 caps keys at 32 bits; its digit window semantics,
    invokers.cu:15, are reproduced here over a 64-bit word).

    Digits are bits [offset, offset+width) of the ORDER-PRESERVING encoded
    word (raw bits for uint64; sign-flipped for int64, totalOrder-mapped
    for float64 — so digit groups ascend in key order), offset+width <= 64,
    width <= 32.  Boundaries are uint32[2^width] with the exact reference
    backfill semantics (sort.cu:367-394).  ``stable`` as in
    :func:`sort_partial`: True = stable by input order (one stable 1-key
    digit sort over (hi, lo) operand lanes), False = the reference's
    checked groups-only contract via a keys-only 2-lane sort of the
    digit-rotated word (~the full-sort rate).  Host-facing.
    """
    import numpy as np

    from .boundaries import compute_boundaries

    np_keys = np.asarray(keys)
    shi, slo, sd = _sort_partial_u64_impl(keys, offset, width, stable)
    b = compute_boundaries(sd, 0, width)
    return _words_to_np64(shi, slo, np_keys.dtype), np.asarray(b)


def sort_partial_counts_u64(
    keys, offset: int, width: int, *, stable: bool = True
) -> tuple:
    """Partial sort + exact per-digit counts (int32[2^width]) for 64-bit
    keys — the 64-bit twin of :func:`sort_partial_counts` (exact histogram
    metadata, immune to the reference boundary quirks)."""
    import numpy as np

    from .boundaries import digit_counts_sorted

    np_keys = np.asarray(keys)
    shi, slo, sd = _sort_partial_u64_impl(keys, offset, width, stable)
    c = digit_counts_sorted(sd, 0, width)
    return _words_to_np64(shi, slo, np_keys.dtype), np.asarray(c)
