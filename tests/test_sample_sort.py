"""Distributed sample sort (PSRS) on the 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from gpu_radix_sort_tpu.parallel import distributed, key_mesh, sample_sort
from gpu_radix_sort_tpu.utils.keygen import (
    Pcg32,
    generate_payloads,
    generate_zipf_keys,
)


def _mesh():
    return key_mesh(jax.devices("cpu"))


@pytest.mark.parametrize("n", [64, 1111, 4099, 1 << 15])
def test_sample_sort_exact(n):
    keys = Pcg32().fill(n)
    out = sample_sort.sort_distributed_sample(keys, mesh=_mesh())
    np.testing.assert_array_equal(out, np.sort(keys))


def test_sample_sort_skewed():
    # Zipf value skew: splitters adapt (unlike fixed radix ranges).
    keys = generate_zipf_keys(1 << 14, alpha=1.2, seed=5)
    out = sample_sort.sort_distributed_sample(
        keys, mesh=_mesh(), capacity_factor=2.5
    )
    np.testing.assert_array_equal(out, np.sort(keys))


def test_sample_sort_all_equal_no_fallback():
    """Composite (rank, chip) splitters round-robin each key's ties across
    chips: all-equal keys sort through the sample path at capacity factor
    1.0 with NO overflow and NO fallback (VERDICT r2 item 3)."""
    keys = np.full(1 << 13, 42, dtype=np.uint32)
    out = sample_sort.sort_distributed_sample(
        keys, mesh=_mesh(), capacity_factor=1.0, fallback=False
    )
    np.testing.assert_array_equal(out, keys)


def test_sample_sort_duplicate_heavy_no_fallback():
    """A handful of hot values (Zipf-like mass) stays on the sample path."""
    rng = np.random.default_rng(7)
    keys = rng.choice(
        np.array([3, 3, 3, 7, 0xFFFFFFFF], dtype=np.uint32), size=1 << 14
    )
    out = sample_sort.sort_distributed_sample(
        keys, mesh=_mesh(), capacity_factor=1.2, fallback=False
    )
    np.testing.assert_array_equal(out, np.sort(keys))


def test_sample_sort_presorted_self_destined_no_fallback():
    """Already-sorted input is entirely self-destined; the diagonal bypass
    carries it locally with no capacity constraint."""
    keys = np.sort(Pcg32().fill(1 << 14))
    out = sample_sort.sort_distributed_sample(
        keys, mesh=_mesh(), capacity_factor=1.0, fallback=False
    )
    np.testing.assert_array_equal(out, keys)


def test_sample_sort_overflow_on_adversarial_placement():
    """Reverse-BLOCK-sorted input (chip i holds exactly chip P-1-i's output
    range, all off-diagonal) still overflows a too-small capacity — and the
    fallback remains exact."""
    keys = np.sort(Pcg32().fill(1 << 13))
    nchips = len(jax.devices("cpu"))
    blocks = keys.reshape(nchips, -1)[::-1].copy().reshape(-1)
    with pytest.raises(distributed.OverflowError_):
        sample_sort.sort_distributed_sample(
            blocks, mesh=_mesh(), capacity_factor=1.0, fallback=False
        )
    out = sample_sort.sort_distributed_sample(
        blocks, mesh=_mesh(), capacity_factor=1.0
    )
    np.testing.assert_array_equal(out, keys)


def test_sample_sort_tiny():
    for n in (1, 7, 9):
        keys = Pcg32().fill(n)
        out = sample_sort.sort_distributed_sample(keys, mesh=_mesh())
        np.testing.assert_array_equal(out, np.sort(keys))


# ---------------------------------------------------------------------------
# Key-value distributed sort (BASELINE.json config 3)
# ---------------------------------------------------------------------------

def _kv_oracle(keys, values):
    order = np.argsort(keys, kind="stable")
    return keys[order], values[order]


def test_kv_sample_sort_stable_exact():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1 << 10, size=9000).astype(np.uint32)  # many dupes
    vals = np.arange(9000, dtype=np.uint32).reshape(-1, 1)  # provenance
    gk, gv = sample_sort.sort_key_value_distributed(keys, vals)
    wk, wv = _kv_oracle(keys, vals)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)  # stability: exact payload order


def test_kv_sample_sort_byte_payload():
    keys = Pcg32().fill(4099)
    payload = generate_payloads(4099, payload_bytes=64)  # (n, 64) uint8
    gk, gv = sample_sort.sort_key_value_distributed(keys, payload)
    wk, wv = _kv_oracle(keys, payload)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)
    assert gv.dtype == np.uint8 and gv.shape == (4099, 64)


def test_kv_sample_sort_max_key_payload_survives_padding():
    """Real 0xFFFFFFFF keys must keep their payloads despite padding rows
    carrying the same key value."""
    keys = np.array([0xFFFFFFFF, 5, 0xFFFFFFFF, 5, 0xFFFFFFFF] * 5,
                    dtype=np.uint32)  # 25 rows over 8 chips -> padding
    vals = np.arange(25, dtype=np.uint32).reshape(-1, 1)
    gk, gv = sample_sort.sort_key_value_distributed(keys, vals)
    wk, wv = _kv_oracle(keys, vals)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)


def test_kv_sample_sort_all_equal_stable():
    """All-equal keys in the kv variant are self-destined under the stable
    (chip, rank) tie order; the diagonal bypass keeps them on the sample
    path and the output preserves exact global input order."""
    keys = np.full(1 << 12, 9, dtype=np.uint32)
    vals = np.arange(1 << 12, dtype=np.uint32).reshape(-1, 1)
    gk, gv = sample_sort.sort_key_value_distributed(
        keys, vals, capacity_factor=1.0
    )
    np.testing.assert_array_equal(gk, keys)
    np.testing.assert_array_equal(gv, vals)  # stability: identity order


def test_kv_sample_sort_presorted_stable():
    keys = np.sort(Pcg32().fill(1 << 13))
    vals = np.arange(1 << 13, dtype=np.uint32).reshape(-1, 1)
    gk, gv = sample_sort.sort_key_value_distributed(
        keys, vals, capacity_factor=1.0
    )
    wk, wv = _kv_oracle(keys, vals)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)


def test_kv_sample_sort_rejects_bad_payload():
    keys = Pcg32().fill(64)
    with pytest.raises(ValueError, match="uint8"):
        sample_sort.sort_key_value_distributed(
            keys, np.zeros((64, 3), np.uint8)
        )
    with pytest.raises(ValueError, match="rows"):
        sample_sort.sort_key_value_distributed(
            keys, np.zeros((32, 4), np.uint8)
        )


@pytest.mark.parametrize("n", [1111, 1 << 13])
def test_sort_distributed_64_u64(n):
    """Distributed 64-bit keys: two stable kv PSRS stages (lo then hi) —
    exceeds the reference's uint32-only C ABI (libsort.h:19)."""
    rng = np.random.default_rng(19)
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    keys[:4] = [0, np.iinfo(np.uint64).max, 1 << 32, (1 << 32) - 1]
    out = sample_sort.sort_distributed_64(keys, mesh=_mesh())
    assert out.dtype == np.uint64
    np.testing.assert_array_equal(out, np.sort(keys))


def test_sort_distributed_64_hi_collisions():
    """Many keys sharing hi words: the lo-pass ordering must survive the
    stable hi-pass (the LSD composition's whole point)."""
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 4, 4096, dtype=np.uint64) << np.uint64(32)
    lo = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    keys = hi | lo
    out = sample_sort.sort_distributed_64(keys, mesh=_mesh())
    np.testing.assert_array_equal(out, np.sort(keys))


def test_sort_distributed_64_typed():
    rng = np.random.default_rng(23)
    i64 = rng.integers(-(1 << 63), 1 << 63, 3000, dtype=np.int64)
    i64[:3] = [np.iinfo(np.int64).min, -1, np.iinfo(np.int64).max]
    got = sample_sort.sort_distributed_64(i64, mesh=_mesh())
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.sort(i64))

    f64 = rng.standard_normal(3000)
    f64[:4] = [-np.inf, np.inf, -0.0, 0.0]
    got = sample_sort.sort_distributed_64(f64, mesh=_mesh())
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.sort(f64))
    z = sample_sort.sort_distributed_64(
        np.array([0.0, -0.0], np.float64), mesh=_mesh()
    )
    np.testing.assert_array_equal(np.signbit(z), [True, False])


def test_sort_distributed_64_rejects_narrow():
    with pytest.raises(TypeError, match="uint64"):
        sample_sort.sort_distributed_64(np.zeros(8, np.uint32))


def test_sort_distributed_64_lsd_cross_check():
    """single_pass=False runs the independent two-stage kv LSD
    composition; both paths must agree bit-for-bit."""
    rng = np.random.default_rng(41)
    keys = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    one = sample_sort.sort_distributed_64(keys, mesh=_mesh())
    two = sample_sort.sort_distributed_64(
        keys, mesh=_mesh(), single_pass=False
    )
    np.testing.assert_array_equal(one, two)
    np.testing.assert_array_equal(one, np.sort(keys))


@pytest.mark.parametrize(
    "case", ["all_equal", "hi_equal", "full_range_dupes"]
)
def test_sort_distributed_64_single_pass_duplicates(case):
    """Duplicate-adversarial inputs on the single-pass (hi, lo)-lane PSRS:
    composite splitters must keep partitions balanced and the lo-word
    segment refinement must be exact inside hi-word tie runs."""
    rng = np.random.default_rng(7)
    n = 1 << 13
    if case == "all_equal":
        keys = np.full(n, 0xDEADBEEFCAFEF00D, dtype=np.uint64)
    elif case == "hi_equal":
        keys = (np.uint64(5) << np.uint64(32)) | rng.integers(
            0, 8, n, dtype=np.uint64
        )
    else:
        keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        keys[::3] = keys[0]
        keys[1::5] = np.uint64(0xFFFFFFFFFFFFFFFF)
    out = sample_sort.sort_distributed_64(keys, mesh=_mesh())
    np.testing.assert_array_equal(out, np.sort(keys))


def test_sort_distributed_64_overflow_falls_back():
    """Adversarial cross-chip placement at a tiny capacity overflows the
    single-pass exchange; the wrapper must fall through to the LSD
    composition (capacity_factor still tiny there, but its gather-exchange
    fallback is exact) rather than fail or return short."""
    P_ = len(jax.devices())
    n = P_ * 512
    # globally reverse-block-sorted: chip i holds exactly the keys
    # destined to chip P-1-i -> one (src, dst) pair carries all n/P local
    # keys, far above the default capacity int(n/P**2 * 1.5) + 64; the
    # LSD stages redistribute by lo/hi words (even spread), so the
    # fallback itself stays within capacity
    keys = np.sort(
        np.random.default_rng(11).integers(0, 1 << 64, n, dtype=np.uint64)
    )[::-1].copy()
    out = sample_sort.sort_distributed_64(keys, mesh=_mesh())
    np.testing.assert_array_equal(out, np.sort(keys))


def _kv64_oracle(keys, vals):
    from gpu_radix_sort_tpu.ops.bits import encode_ordered_np64

    order = np.argsort(encode_ordered_np64(np.asarray(keys)), kind="stable")
    return np.asarray(keys)[order], np.asarray(vals)[order]


@pytest.mark.parametrize("n,W", [(1111, 2), (1 << 13, 6)])
def test_sort_kv_distributed_64(n, W):
    """Distributed stable kv sort with 64-bit keys: single-pass (hi, lo)
    kv PSRS, narrow (lane-riding) and wide (gather) payload routes."""
    rng = np.random.default_rng(29)
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    # interleaved duplicates (~n/8): stability must hold; kept below the
    # per-pair capacity — duplicate mass POURED onto one destination is the
    # kv paths' documented overflow mode (module docstring), not a test bug
    keys[::8] = keys[0]
    vals = rng.integers(0, 1 << 32, (n, W), dtype=np.uint64).astype(np.uint32)
    gk, gv = sample_sort.sort_key_value_distributed_64(
        keys, vals, mesh=_mesh()
    )
    wk, wv = _kv64_oracle(keys, vals)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)


def test_sort_kv_distributed_64_all_equal():
    """All-equal keys: every tie is self-destined in the stable (chip,
    rank) order — the diagonal bypass carries the whole input, zero
    exchange, stability = identity."""
    n = 4096
    keys = np.full(n, 0x0123456789ABCDEF, dtype=np.uint64)
    vals = np.arange(n, dtype=np.uint32)[:, None]
    gk, gv = sample_sort.sort_key_value_distributed_64(
        keys, vals, mesh=_mesh()
    )
    np.testing.assert_array_equal(gk, keys)
    np.testing.assert_array_equal(gv, vals)


def test_sort_kv_distributed_64_lsd_cross_check():
    rng = np.random.default_rng(31)
    n = 3000
    keys = (rng.integers(0, 4, n, dtype=np.uint64) << np.uint64(32)) | (
        rng.integers(0, 16, n, dtype=np.uint64)
    )
    vals = np.arange(n * 2, dtype=np.uint32).reshape(n, 2)
    one = sample_sort.sort_key_value_distributed_64(keys, vals, mesh=_mesh())
    two = sample_sort.sort_key_value_distributed_64(
        keys, vals, mesh=_mesh(), single_pass=False
    )
    np.testing.assert_array_equal(one[0], two[0])
    np.testing.assert_array_equal(one[1], two[1])
    wk, wv = _kv64_oracle(keys, vals)
    np.testing.assert_array_equal(one[0], wk)
    np.testing.assert_array_equal(one[1], wv)


def test_sort_kv_distributed_64_typed_and_bytes():
    rng = np.random.default_rng(37)
    n = 2048
    f64 = rng.standard_normal(n)
    f64[:4] = [-np.inf, np.inf, -0.0, 0.0]
    payload = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    gk, gv = sample_sort.sort_key_value_distributed_64(
        f64, payload, mesh=_mesh()
    )
    assert gk.dtype == np.float64 and gv.dtype == np.uint8
    wk, wv = _kv64_oracle(f64, payload)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)


def test_sort_kv_distributed_64_overflow_falls_back():
    P_ = len(jax.devices())
    n = P_ * 512
    keys = np.sort(
        np.random.default_rng(13).integers(0, 1 << 64, n, dtype=np.uint64)
    )[::-1].copy()
    vals = np.arange(n, dtype=np.uint32)[:, None]
    gk, gv = sample_sort.sort_key_value_distributed_64(
        keys, vals, mesh=_mesh()
    )
    wk, wv = _kv64_oracle(keys, vals)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)


def test_sort_kv_distributed_64_rejects():
    with pytest.raises(TypeError, match="uint64"):
        sample_sort.sort_key_value_distributed_64(
            np.zeros(8, np.uint32), np.zeros((8, 1), np.uint32)
        )
    with pytest.raises(ValueError, match="rows"):
        sample_sort.sort_key_value_distributed_64(
            np.zeros(8, np.uint64), np.zeros((4, 1), np.uint32)
        )


@pytest.mark.parametrize("case", ["random", "dupes", "presorted"])
def test_sample_sort_merge_reassembly(case):
    """The cases of the removed merge-network reassembly, on the PSRS
    reassembly that remains (one sort over the received buffer plus the
    self slice): exact with no overflow fallback."""
    n = 8 * 2048
    if case == "random":
        keys = Pcg32(state=17).fill(n)
    elif case == "dupes":
        rng = np.random.default_rng(2)
        keys = rng.choice(
            np.array([1, 1, 9, 0xFFFFFFFF], dtype=np.uint32), size=n
        )
    else:
        keys = np.sort(Pcg32(state=23).fill(n))
    out = sample_sort.sort_distributed_sample(
        keys, mesh=_mesh(), fallback=False,
    )
    np.testing.assert_array_equal(out, np.sort(keys))


def test_sample_sort_merge_reassembly_odd_n():
    """Host padding (n not divisible by P) flows through the reassembly's
    PAD handling."""
    keys = Pcg32(state=29).fill(8 * 2048 - 777)
    out = sample_sort.sort_distributed_sample(keys, mesh=_mesh())
    np.testing.assert_array_equal(out, np.sort(keys))


def test_sample_sort_rejects_bad_reassembly():
    with pytest.raises(ValueError, match="reassembly"):
        sample_sort.build_sample_sort(_mesh(), 2048, reassembly="bogus")
    with pytest.raises(ValueError, match="removed"):
        sample_sort.build_sample_sort(_mesh(), 2048, reassembly="merge")
