"""Single-chip sort core: full/partial sort + boundary contract parity.

Mirrors the reference test strategy (SURVEY.md §4): odd sizes (1111, 1021,
4099) to hit non-power-of-2 tiles, exact-match oracles at every level, and
cross-validation of every implementation (JAX/XLA strategy, numpy oracle,
native C++ oracle) against one another.
"""

import numpy as np
import pytest

import gpu_radix_sort_tpu as gst
from gpu_radix_sort_tpu.utils import checks, native
from gpu_radix_sort_tpu.utils.keygen import Pcg32

SIZES = [0, 1, 2, 1111, 1021, 4099, 1 << 14]
WIDTHS = [(0, 8), (8, 8), (24, 8), (0, 16), (16, 16), (0, 4), (30, 2), (0, 1)]


def _keys(n, seed_stream=None):
    return Pcg32().fill(n)


@pytest.mark.parametrize("n", SIZES)
def test_sort_full_exact(n):
    keys = _keys(n)
    out = np.asarray(gst.sort_full(keys, strategy="xla"))
    assert checks.check_sort_full(out, keys)
    assert checks.check_sorted(out)


@pytest.mark.parametrize("n", [1111, 4099])
@pytest.mark.parametrize("offset,width", WIDTHS)
def test_sort_partial_exact(n, offset, width):
    keys = _keys(n)
    out, boundaries = gst.sort_partial(keys, offset, width, strategy="xla")
    out = np.asarray(out)
    boundaries = np.asarray(boundaries)
    assert checks.check_partial(out, keys, offset, width)
    want_b = checks.boundaries_oracle(out, offset, width)
    np.testing.assert_array_equal(boundaries, want_b)


@pytest.mark.parametrize("offset,width", [(0, 8), (8, 4)])
def test_partial_counts_exact(offset, width):
    keys = _keys(4099)
    out, counts = gst.sort_partial_counts(keys, offset, width, strategy="xla")
    np.testing.assert_array_equal(
        np.asarray(counts), checks.true_bucket_counts(keys, offset, width)
    )
    assert checks.check_partial(np.asarray(out), keys, offset, width)


@pytest.mark.parametrize("offset,width", [(0, 4), (8, 8), (16, 16), (28, 4),
                                          (24, 8), (5, 7)])
def test_sort_partial_refcontract(offset, width):
    """stable=False: the reference's checked contract (groups in order +
    multiset, pylibsort/sort.py:67-91) via a keys-only full sort of the
    digit-rotated word.  Within-group order is the deterministic
    rotated-value order, so the result is also BIT-EXACT against a numpy
    rotation oracle."""
    keys = _keys(4099)
    out, boundaries = gst.sort_partial(keys, offset, width, stable=False)
    out = np.asarray(out)
    assert checks.check_partial_groups(out, keys, offset, width)
    s = (offset + width) % 32
    rot = (keys >> np.uint32(s)) | (keys << np.uint32(32 - s)) if s else keys
    srt = np.sort(rot)
    back = (
        (srt << np.uint32(s)) | (srt >> np.uint32(32 - s)) if s else srt
    )
    np.testing.assert_array_equal(out, back)
    # boundaries are order-independent within groups: identical to stable's
    np.testing.assert_array_equal(
        np.asarray(boundaries), checks.boundaries_oracle(out, offset, width)
    )
    _, stable_b = gst.sort_partial(keys, offset, width, strategy="xla")
    np.testing.assert_array_equal(np.asarray(boundaries), np.asarray(stable_b))


def test_sort_partial_counts_refcontract():
    keys = _keys(8191)
    out, counts = gst.sort_partial_counts(keys, 8, 8, stable=False)
    assert checks.check_partial_groups(np.asarray(out), keys, 8, 8)
    np.testing.assert_array_equal(
        np.asarray(counts), checks.true_bucket_counts(keys, 8, 8)
    )


def test_sort_by_digits_refcontract_full_width():
    """width=32 at offset 0: the rotation is the identity and stable=False
    degenerates to a plain full sort (boundary-free path only — a
    2^width boundary array is the caller's choice to avoid)."""
    keys = _keys(4099)
    out = np.asarray(gst.sort_by_digits(keys, 0, 32, stable=False))
    np.testing.assert_array_equal(out, np.sort(keys))


def test_check_partial_groups_rejects():
    """The oracle itself must catch wrong groups and multiset swaps."""
    keys = _keys(512)
    out = np.asarray(gst.sort_by_digits(keys, 0, 4, stable=False))
    assert checks.check_partial_groups(out, keys, 0, 4)
    bad = out.copy()
    bad[0] ^= np.uint32(1 << 0)  # flips digit bit -> group order breaks
    assert not checks.check_partial_groups(bad, keys, 0, 4)
    bad2 = out.copy()
    bad2[0] ^= np.uint32(1 << 20)  # same digit, different key: multiset
    assert not checks.check_partial_groups(bad2, keys, 0, 4)


def test_partial_stability():
    # Equal digits must preserve input order: encode provenance in low bits
    # (reference fixture pattern: values encode (partId<<4)|arrId,
    # testHelpers.go:123-154).
    n = 2048
    provenance = np.arange(n, dtype=np.uint32)
    digits = np.asarray(Pcg32().fill(n) & 0xF, dtype=np.uint32)
    keys = (digits << np.uint32(16)) | provenance
    out, _ = gst.sort_partial(keys, 16, 4, strategy="xla")
    out = np.asarray(out)
    for d in range(16):
        grp = out[(out >> 16) & 0xF == d]
        assert np.all(np.diff(grp & 0xFFFF) > 0), f"digit {d} not stable"


def test_boundary_backfill_quirks():
    """The reference never backfills group 1 and never marks element 0's
    group (sort.cu:367-394); verify bit-exact parity on crafted inputs."""
    # All elements in group 3 (width 4): groups 0-2 empty.
    keys = np.full(10, 3 << 4, dtype=np.uint32)
    _, b = gst.sort_partial(keys, 4, 4, strategy="xla")
    b = np.asarray(b)
    want = checks.boundaries_oracle(keys, 4, 4)
    np.testing.assert_array_equal(b, want)
    # Reference contract: b[0]=0, b[1]=0 (quirk: un-backfilled), b[2]=0
    # (backfilled from b[3]... wait b[3]=0 as group 3 starts at elem 0 and
    # is never marked; b[4..15] = 10).
    assert b[0] == 0 and b[1] == 0
    assert np.all(b[4:] == 10)

    # Group 1 empty, groups 0 and 2 present.
    keys = np.array([0, 0, 2 << 4, 2 << 4, 2 << 4], dtype=np.uint32)
    _, b = gst.sort_partial(keys, 4, 4, strategy="xla")
    b = np.asarray(b)
    np.testing.assert_array_equal(b, checks.boundaries_oracle(keys, 4, 4))
    assert b[1] == 0  # quirk preserved
    assert b[2] == 2


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
@pytest.mark.parametrize("offset,width", [(0, 8), (8, 8), (0, 16)])
def test_native_oracle_agrees(offset, width):
    keys = _keys(4099)
    got_sorted, got_b = native.cpu_partial(keys, offset, width)
    want_sorted = checks.partial_sort_oracle(keys, offset, width)
    np.testing.assert_array_equal(got_sorted, want_sorted)
    np.testing.assert_array_equal(
        got_b, checks.boundaries_oracle(want_sorted, offset, width)
    )
    jx_sorted, jx_b = gst.sort_partial(keys, offset, width, strategy="xla")
    np.testing.assert_array_equal(np.asarray(jx_sorted), got_sorted)
    np.testing.assert_array_equal(np.asarray(jx_b), got_b)


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_full_sort():
    keys = _keys(1111)
    got = native.cpu_sort(keys)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_key_value_stable():
    n = 4099
    keys = (Pcg32().fill(n) & np.uint32(0xFF)).astype(np.uint32)  # many dups
    vals = np.arange(n, dtype=np.uint32)
    sk, sv = gst.sort_key_value(keys, vals)
    sk, sv = np.asarray(sk), np.asarray(sv)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(sk, keys[order])
    np.testing.assert_array_equal(sv, order.astype(np.uint32))


def test_sort_key_value_wide_payload():
    n = 1021
    keys = Pcg32().fill(n)
    payload = gst.generate_payloads(n, payload_bytes=64)
    sk, sp = gst.sort_key_value(keys, payload)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), keys[order])
    np.testing.assert_array_equal(np.asarray(sp), payload[order])


@pytest.mark.parametrize("payload_bytes", [8, 16])
def test_sort_key_value_lane_payload(payload_bytes):
    # <= MAX_SORT_LANES u32 lanes ride the sort as operands (no gather);
    # duplicate-heavy keys exercise the stability contract on that path.
    n = 4099
    keys = (Pcg32().fill(n) & np.uint32(0x3F)).astype(np.uint32)
    payload = gst.generate_payloads(n, payload_bytes=payload_bytes)
    sk, sp = gst.sort_key_value(keys, payload)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), keys[order])
    np.testing.assert_array_equal(np.asarray(sp), payload[order])


def test_sort_key_value_u32_lanes():
    n = 2048
    keys = (Pcg32().fill(n) & np.uint32(0xFFF)).astype(np.uint32)
    vals = np.stack([np.arange(n, dtype=np.uint32),
                     Pcg32(state=7).fill(n)], axis=1)  # (n, 2) u32 lanes
    sk, sv = gst.sort_key_value(keys, vals)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), keys[order])
    np.testing.assert_array_equal(np.asarray(sv), vals[order])


def test_sort_key_value_wide_payload_duplicate_keys():
    # Wide payloads move via grouped lane-riding sorts keyed by the
    # destination rank; duplicate-heavy keys prove the rank inherits the
    # key sort's stability (the group sorts themselves are unstable —
    # ranks are all distinct).
    n = 4099
    keys = (Pcg32().fill(n) & np.uint32(0x1F)).astype(np.uint32)
    payload = gst.generate_payloads(n, payload_bytes=64)
    sk, sp = gst.sort_key_value(keys, payload)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), keys[order])
    np.testing.assert_array_equal(np.asarray(sp), payload[order])


def test_sort_key_value_by_digits_wide_payload():
    n = 2111
    keys = Pcg32().fill(n)
    payload = gst.generate_payloads(n, payload_bytes=32)  # 8 u32 lanes
    sk, sp = gst.sort_key_value_by_digits(keys, payload, 8, 8)
    digits = (keys >> 8) & 0xFF
    order = np.argsort(digits, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), keys[order])
    np.testing.assert_array_equal(np.asarray(sp), payload[order])


def test_kv_digits_pallas_radix_rejects_wide_payload():
    """An explicit strategy='pallas_radix' must not silently run the XLA
    path: the removed kernel's name raises for any payload (mirrors
    sort_full's explicit-strategy contract)."""
    import pytest

    from gpu_radix_sort_tpu.ops.radix_sort import sort_key_value_by_digits

    keys = Pcg32(3).fill(4096)
    wide = np.zeros((4096, 4), dtype=np.uint32)
    with pytest.raises(ValueError, match="pallas_radix"):
        sort_key_value_by_digits(keys, wide, 0, 4, strategy="pallas_radix")


def test_sort_key_value_unaligned_payload_gather_fallback():
    # Payload widths not bitcastable to u32 lanes keep the permutation
    # gather; exactness (not speed) is the contract there.
    n = 1021
    keys = (Pcg32().fill(n) & np.uint32(0xFF)).astype(np.uint32)
    payload = gst.generate_payloads(n, payload_bytes=7)
    sk, sp = gst.sort_key_value(keys, payload)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), keys[order])
    np.testing.assert_array_equal(np.asarray(sp), payload[order])


def test_sort_key_value_by_digits_lane_payload():
    n = 1111
    keys = Pcg32().fill(n)
    payload = gst.generate_payloads(n, payload_bytes=8)  # 2 u32 lanes
    sk, sp = gst.sort_key_value_by_digits(keys, payload, 4, 8)
    digits = (keys >> 4) & 0xFF
    order = np.argsort(digits, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), keys[order])
    np.testing.assert_array_equal(np.asarray(sp), payload[order])


def test_sort_key_value_by_digits():
    n = 1111
    keys = Pcg32().fill(n)
    vals = np.arange(n, dtype=np.uint32)
    sk, sv = gst.sort_key_value_by_digits(keys, vals, 8, 8)
    digits = (keys >> 8) & 0xFF
    order = np.argsort(digits, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), keys[order])
    np.testing.assert_array_equal(np.asarray(sv), vals[order])


def test_invalid_digit_ranges_rejected():
    keys = _keys(16)
    for offset, width in [(0, 0), (0, 33), (30, 4), (-1, 4), (32, 1)]:
        with pytest.raises(ValueError):
            gst.sort_partial(keys, offset, width, strategy="xla")


def test_jit_composability():
    import jax

    keys = _keys(2048)

    @jax.jit
    def step(k):
        s, b = gst.sort_partial(k, 0, 8, strategy="xla")
        return s, b

    s, b = step(keys)
    assert checks.check_partial(np.asarray(s), keys, 0, 8)
    np.testing.assert_array_equal(
        np.asarray(b), checks.boundaries_oracle(np.asarray(s), 0, 8)
    )


# ---------------------------------------------------------------------------
# Typed keys (int32 / float32 via the order-preserving u32 bijection)
# ---------------------------------------------------------------------------

def test_sort_full_int32_keys():
    from gpu_radix_sort_tpu.ops.radix_sort import sort_full

    rng = np.random.default_rng(0)
    keys = rng.integers(-(1 << 31), 1 << 31, 5000, dtype=np.int64).astype(
        np.int32
    )
    keys[:5] = [np.iinfo(np.int32).min, -1, 0, 1, np.iinfo(np.int32).max]
    got = np.asarray(sort_full(keys))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_full_float32_keys():
    from gpu_radix_sort_tpu.ops.radix_sort import sort_full

    rng = np.random.default_rng(1)
    keys = rng.standard_normal(5000).astype(np.float32)
    keys[:6] = [np.float32(x) for x in
                (-np.inf, np.inf, -0.0, 0.0, 1e-38, -1e38)]
    got = np.asarray(sort_full(keys))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.sort(keys))
    # -0.0 must order before +0.0 (totalOrder refinement)
    z = np.asarray(sort_full(np.array([0.0, -0.0, 0.0, -0.0], np.float32)))
    np.testing.assert_array_equal(
        np.signbit(z), np.array([True, True, False, False])
    )


def test_sort_full_float32_total_order_nans():
    """IEEE totalOrder: -NaN < -inf <= finite <= +inf < +NaN (np.sort
    instead moves all NaNs last — the bijection is checked directly)."""
    from gpu_radix_sort_tpu.ops.bits import decode_ordered, encode_ordered
    from gpu_radix_sort_tpu.ops.radix_sort import sort_full

    neg_nan = np.uint32(0xFFC00000).view(np.float32)
    pos_nan = np.float32(np.nan)
    keys = np.array(
        [pos_nan, 1.5, -np.inf, neg_nan, np.inf, -2.5], np.float32
    )
    got = np.asarray(sort_full(keys))
    assert np.isnan(got[0]) and np.signbit(got[0])   # -NaN first
    np.testing.assert_array_equal(got[1:5], [-np.inf, -2.5, 1.5, np.inf])
    assert np.isnan(got[5]) and not np.signbit(got[5])  # +NaN last
    # encode/decode round-trips bit-exactly (NaN payloads included)
    import jax.numpy as jnp

    enc = encode_ordered(jnp.asarray(keys))
    dec = np.asarray(decode_ordered(enc, np.float32))
    np.testing.assert_array_equal(dec.view(np.uint32), keys.view(np.uint32))


def test_sort_key_value_typed_keys_stable():
    from gpu_radix_sort_tpu.ops.radix_sort import sort_key_value

    rng = np.random.default_rng(2)
    keys = rng.integers(-50, 50, 4000).astype(np.int32)  # heavy duplicates
    vals = np.arange(4000, dtype=np.uint32)
    gk, gv = sort_key_value(keys, vals)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(gk), keys[order])
    np.testing.assert_array_equal(np.asarray(gv), order.astype(np.uint32))


@pytest.mark.parametrize("W", [1, 3, 6])
def test_sort_key_value_u64(W):
    """Single-chip stable kv sort with 64-bit keys: lane-riding (W<=4)
    and grouped-permutation (W>4) payload routes, duplicate keys."""
    from gpu_radix_sort_tpu.ops.radix_sort import sort_key_value_u64

    rng = np.random.default_rng(17)
    n = 4096
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    keys[::5] = keys[0]  # stability-visible duplicate mass
    vals = rng.integers(0, 1 << 32, (n, W), dtype=np.uint64).astype(np.uint32)
    gk, gv = sort_key_value_u64(keys, vals)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, vals[order])


def test_sort_key_value_u64_typed_scalar_payload():
    from gpu_radix_sort_tpu.ops.radix_sort import sort_key_value_u64

    rng = np.random.default_rng(19)
    n = 3000
    f64 = rng.standard_normal(n)
    f64[:4] = [-np.inf, np.inf, -0.0, 0.0]
    vals = np.arange(n, dtype=np.uint32)
    gk, gv = sort_key_value_u64(f64, vals)
    order = np.argsort(f64, kind="stable")
    # np.argsort orders -0.0/0.0 arbitrarily among equals; compare via the
    # encoded totalOrder instead
    from gpu_radix_sort_tpu.ops.bits import encode_ordered_np64

    order = np.argsort(encode_ordered_np64(f64), kind="stable")
    assert gk.dtype == np.float64
    np.testing.assert_array_equal(gk, f64[order])
    np.testing.assert_array_equal(gv, vals[order])

    with pytest.raises(TypeError, match="uint64"):
        sort_key_value_u64(np.zeros(4, np.uint32), vals[:4])
    with pytest.raises(ValueError, match="leading axis"):
        sort_key_value_u64(np.zeros(4, np.uint64), vals[:3])


def _digit64(enc: np.ndarray, offset: int, width: int) -> np.ndarray:
    return ((enc >> np.uint64(offset)) & np.uint64((1 << width) - 1)).astype(
        np.uint32
    )


@pytest.mark.parametrize("offset,width", [(0, 8), (28, 8), (32, 4),
                                          (48, 16), (60, 4), (5, 7)])
def test_sort_partial_u64(offset, width):
    """64-bit partial sorts: stable-by-input-order digit sort over a
    64-bit window (incl. word-straddling ones) + reference-contract
    boundaries."""
    from gpu_radix_sort_tpu.ops.radix_sort import sort_partial_u64

    rng = np.random.default_rng(31)
    keys = rng.integers(0, 1 << 64, 4099, dtype=np.uint64)
    keys[::7] = keys[1]  # stability-visible duplicate mass
    got, boundaries = sort_partial_u64(keys, offset, width)
    digit = _digit64(keys, offset, width)
    order = np.argsort(digit, kind="stable")
    np.testing.assert_array_equal(got, keys[order])
    np.testing.assert_array_equal(
        boundaries,
        checks.boundaries_oracle(digit[order], 0, width),
    )


@pytest.mark.parametrize("offset,width", [(0, 8), (28, 8), (48, 16),
                                          (32, 32), (0, 32)])
def test_sort_partial_counts_u64_refcontract(offset, width):
    """stable=False over 64-bit windows: groups-only contract via the
    rotated keys-only 2-lane sort — bit-exact against a numpy uint64
    rotation oracle; counts exact; width=32 windows (whole words) hit the
    swap/rotate-back word-lane edge cases (sort-only there: a 2^32 count
    array is the caller's choice to avoid, as in the 32-bit width-32
    surface)."""
    from gpu_radix_sort_tpu.ops.radix_sort import (
        _sort_partial_u64_impl,
        _words_to_np64,
        sort_partial_counts_u64,
    )

    rng = np.random.default_rng(33)
    keys = rng.integers(0, 1 << 64, 4099, dtype=np.uint64)
    if width <= 16:
        got, counts = sort_partial_counts_u64(
            keys, offset, width, stable=False
        )
        digit = _digit64(keys, offset, width)
        np.testing.assert_array_equal(
            counts, np.bincount(digit, minlength=1 << width).astype(np.int32)
        )
    else:
        shi, slo, _ = _sort_partial_u64_impl(keys, offset, width, False)
        got = _words_to_np64(shi, slo, keys.dtype)
    s = (offset + width) % 64
    rot = (keys >> np.uint64(s)) | (keys << np.uint64(64 - s)) if s else keys
    srt = np.sort(rot)
    back = (
        (srt << np.uint64(s)) | (srt >> np.uint64(64 - s)) if s else srt
    )
    np.testing.assert_array_equal(got, back)


def test_sort_partial_u64_typed_and_errors():
    """int64/float64 keys: digits are windows of the ORDER-PRESERVING
    encoded word, so digit groups ascend in key order; stable within."""
    from gpu_radix_sort_tpu.ops.bits import encode_ordered_np64
    from gpu_radix_sort_tpu.ops.radix_sort import (
        sort_partial_counts_u64,
        sort_partial_u64,
    )

    rng = np.random.default_rng(37)
    i64 = rng.integers(-(1 << 62), 1 << 62, 3000, dtype=np.int64)
    i64[:3] = [np.iinfo(np.int64).min, -1, np.iinfo(np.int64).max]
    got, b = sort_partial_u64(i64, 56, 8)
    enc = encode_ordered_np64(i64)
    order = np.argsort(_digit64(enc, 56, 8), kind="stable")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, i64[order])

    f64 = rng.standard_normal(3000)
    f64[:4] = [-np.inf, np.inf, -0.0, 0.0]
    enc = encode_ordered_np64(f64)
    got, counts = sort_partial_counts_u64(f64, 60, 4, stable=False)
    # top-4-bit groups of the totalOrder encoding ascend in key order
    np.testing.assert_array_equal(
        _digit64(encode_ordered_np64(got), 60, 4),
        np.sort(_digit64(enc, 60, 4)),
    )
    np.testing.assert_array_equal(np.sort(got), np.sort(f64))
    np.testing.assert_array_equal(
        counts, np.bincount(_digit64(enc, 60, 4), minlength=16)
    )

    with pytest.raises(TypeError, match="uint64"):
        sort_partial_u64(np.zeros(4, np.uint32), 0, 4)
    with pytest.raises(ValueError, match="64-bit digit range"):
        sort_partial_u64(np.zeros(4, np.uint64), 60, 8)
    with pytest.raises(ValueError, match="64-bit digit range"):
        sort_partial_u64(np.zeros(4, np.uint64), 0, 33)


def test_sort_full_u64_typed():
    """64-bit keys (u64/i64/f64) via one lexicographic 2-lane sort."""
    from gpu_radix_sort_tpu.ops.radix_sort import sort_full_u64

    rng = np.random.default_rng(7)
    u64 = rng.integers(0, 1 << 64, 5000, dtype=np.uint64)
    u64[:3] = [0, np.iinfo(np.uint64).max, 1 << 32]
    np.testing.assert_array_equal(np.asarray(sort_full_u64(u64)), np.sort(u64))

    i64 = rng.integers(-(1 << 63), 1 << 63, 5000, dtype=np.int64)
    i64[:3] = [np.iinfo(np.int64).min, -1, np.iinfo(np.int64).max]
    got = sort_full_u64(i64)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.sort(i64))

    f64 = rng.standard_normal(5000)
    f64[:4] = [-np.inf, np.inf, -0.0, 0.0]
    got = sort_full_u64(f64)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.sort(f64))
    z = sort_full_u64(np.array([0.0, -0.0], np.float64))
    np.testing.assert_array_equal(np.signbit(z), [True, False])


@pytest.mark.parametrize("s", [0, 1, 8, 31, 32, 33, 40, 63, 64, 96])
def test_rotr64_lanes_oracle(s):
    """rotr64_lanes (the fused u64 device rounds' workhorse) vs a numpy
    uint64 rotation oracle at every shift class: 0, sub-word, exactly one
    word, cross-word, full turn, beyond."""
    import jax.numpy as jnp

    from gpu_radix_sort_tpu.ops.bits import rotr64_lanes

    rng = np.random.default_rng(s)
    v = rng.integers(0, 1 << 64, 1000, dtype=np.uint64)
    hi = jnp.asarray((v >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    h2, l2 = rotr64_lanes(hi, lo, s)
    got = (np.asarray(h2).astype(np.uint64) << np.uint64(32)) | np.asarray(
        l2
    ).astype(np.uint64)
    r = s % 64
    want = ((v >> np.uint64(r)) | (v << np.uint64(64 - r))) if r else v
    np.testing.assert_array_equal(got, want)
