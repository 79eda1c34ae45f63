"""Parameter grids of the removed Pallas sort kernels, carried onto the public
API that replaced them (sort_full, sort_by_digits, sort_partial and
sort_key_value_by_digits on plain XLA), against numpy oracles.

The sizes are the kernels' adversarial ones: non-powers of two, single
elements, tile-boundary sizes; the key sets are all-equal, two-valued,
presorted, reversed and full-range (0 and 0xFFFFFFFF are data, never
sentinels)."""

import numpy as np
import pytest

import gpu_radix_sort_tpu as gst
from gpu_radix_sort_tpu.utils.checks import check_partial
from gpu_radix_sort_tpu.utils.keygen import Pcg32


def _oracle(keys, offset, width):
    digits = (keys >> np.uint32(offset)) & np.uint32((1 << width) - 1)
    return keys[np.argsort(digits, kind="stable")]


def _kv_oracle(keys, lanes, offset, width):
    digits = (keys >> np.uint32(offset)) & np.uint32((1 << width) - 1)
    order = np.argsort(digits, kind="stable")
    return keys[order], lanes[order]


# --- stable digit sort: the binning pass grid --------------------------------

@pytest.mark.parametrize("n", [1, 7, 1024, 1111, 4096, 6000, 16384 + 17])
@pytest.mark.parametrize("offset,width", [(0, 4), (8, 4), (28, 4), (5, 3)])
def test_sort_by_digits_exact(n, offset, width):
    keys = Pcg32().fill(n)
    got = np.asarray(gst.sort_by_digits(keys, offset, width))
    np.testing.assert_array_equal(got, _oracle(keys, offset, width))


def test_sort_by_digits_stability_witness():
    # duplicate-heavy digits; keys carry their original index in high bits
    n = 5000
    rng = np.random.default_rng(0)
    digits = rng.integers(0, 16, n, dtype=np.uint32)
    keys = (np.arange(n, dtype=np.uint32) << np.uint32(4)) | digits
    got = np.asarray(gst.sort_by_digits(keys, 0, 4))
    np.testing.assert_array_equal(got, _oracle(keys, 0, 4))


@pytest.mark.parametrize("case", ["all_same", "two_vals", "sorted", "rev"])
def test_sort_by_digits_skew(case):
    n = 4096 + 321
    if case == "all_same":
        keys = np.full(n, 0xDEADBEEF, dtype=np.uint32)
    elif case == "two_vals":
        keys = np.where(
            np.arange(n) % 7 == 0, np.uint32(0xF0), np.uint32(0x0F)
        ).astype(np.uint32)
    elif case == "sorted":
        keys = np.sort(Pcg32().fill(n))
    else:
        keys = np.sort(Pcg32().fill(n))[::-1].copy()
    for offset in (0, 4):
        got = np.asarray(gst.sort_by_digits(keys, offset, 4))
        np.testing.assert_array_equal(got, _oracle(keys, offset, 4))


def test_sort_by_digits_full_range_keys():
    keys = np.array(
        [0xFFFFFFFF, 0, 0xFFFFFFFF, 1, 0xFFFFFFF0, 0, 0xFFFFFFFF] * 300,
        dtype=np.uint32,
    )
    got = np.asarray(gst.sort_by_digits(keys, 28, 4))
    np.testing.assert_array_equal(got, _oracle(keys, 28, 4))


@pytest.mark.parametrize("width", [8, 12, 16])
def test_sort_by_digits_wide_digits(width):
    n = 6000
    keys = Pcg32().fill(n)
    got = np.asarray(gst.sort_by_digits(keys, 4, width))
    np.testing.assert_array_equal(got, _oracle(keys, 4, width))


def test_sort_by_digits_whole_word_is_full_sort():
    keys = Pcg32().fill(5000)
    got = np.asarray(gst.sort_by_digits(keys, 0, 32))
    np.testing.assert_array_equal(got, np.sort(keys))


@pytest.mark.parametrize("offset,width", [(0, 8), (8, 4), (24, 8), (0, 13)])
def test_sort_partial_stable_digit_grid(offset, width):
    keys = Pcg32().fill(4099)
    out, _ = gst.sort_partial(keys, offset, width)
    assert check_partial(np.asarray(out), keys, offset, width)


# --- stable key-value digit sort: the kv lane grid ---------------------------

@pytest.mark.parametrize("n,L", [(1, 1), (1024, 1), (1111, 3), (6000, 1),
                                 (6000, 2)])
def test_sort_key_value_by_digits_lanes_exact(n, L):
    keys = Pcg32().fill(n)
    lanes = np.arange(n * L, dtype=np.uint32).reshape(n, L)  # provenance
    gk, gv = (np.asarray(a) for a in
              gst.sort_key_value_by_digits(keys, lanes, 8, 4))
    wk, wv = _kv_oracle(keys, lanes, 8, 4)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)


def test_sort_key_value_by_digits_stability_duplicates():
    n = 5000
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 8, n, dtype=np.uint32)  # heavy duplicates
    vals = np.arange(n, dtype=np.uint32)
    gk, gv = (np.asarray(a) for a in
              gst.sort_key_value_by_digits(keys, vals, 0, 4))
    wk, wv = _kv_oracle(keys, vals, 0, 4)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)  # payload order = stability proof


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_sort_key_value_by_digits_4byte_payload_dtypes(dtype):
    n = 6000
    keys = Pcg32().fill(n)
    vals = np.arange(n, dtype=np.uint32).view(dtype)
    gk, gv = (np.asarray(a) for a in
              gst.sort_key_value_by_digits(keys, vals, 4, 8))
    wk, wv = _kv_oracle(keys, vals, 4, 8)
    np.testing.assert_array_equal(gk, wk)
    assert gv.dtype == dtype
    np.testing.assert_array_equal(gv.view(np.uint32), wv.view(np.uint32))


# --- full sort: the bitonic and merge kernels' sizes and key sets -------------

@pytest.mark.parametrize(
    "n", [1, 2, 7, 1024, 1025, 2048, 4099, 5000, 1 << 13, 40000]
)
def test_sort_full_sizes(n):
    keys = Pcg32().fill(n)
    np.testing.assert_array_equal(np.asarray(gst.sort_full(keys)),
                                  np.sort(keys))


@pytest.mark.parametrize(
    "maker",
    [
        lambda rng: rng.integers(0, 4, size=6000).astype(np.uint32),
        lambda rng: np.full(4096, 0xFFFFFFFF, dtype=np.uint32),
        lambda rng: np.sort(Pcg32().fill(4096)),
        lambda rng: np.sort(Pcg32().fill(4096))[::-1].copy(),
        lambda rng: np.zeros(3000, dtype=np.uint32),
        lambda rng: np.concatenate(
            [np.full(2000, 7, np.uint32), np.full(2000, 0xFFFFFFFF, np.uint32)]
        ),
        lambda rng: np.array([0xFFFFFFFF, 0, 5, 5, 5, 0xFFFFFFFF, 0, 1] * 200,
                             dtype=np.uint32),
    ],
    ids=["dup-heavy", "all-max", "presorted", "reversed", "all-zero",
         "two-values-with-max", "extremes"],
)
def test_sort_full_adversarial(maker):
    keys = maker(np.random.default_rng(0))
    np.testing.assert_array_equal(np.asarray(gst.sort_full(keys)),
                                  np.sort(keys))


@pytest.mark.parametrize("nruns", [2, 4, 8])
def test_sort_full_of_presorted_runs(nruns):
    """Concatenated sorted runs (the merge kernel's presorted-runs input)."""
    run = 2048
    rng = np.random.default_rng(nruns)
    x = rng.integers(0, 1 << 32, nruns * run, dtype=np.uint32)
    runs = np.sort(x.reshape(nruns, run), axis=1).reshape(-1)
    np.testing.assert_array_equal(np.asarray(gst.sort_full(runs)),
                                  np.sort(x))


def test_sort_full_of_presorted_runs_duplicates_and_max():
    run = 2048
    rng = np.random.default_rng(3)
    x = rng.choice(
        np.array([0, 5, 5, 7, 0xFFFFFFFF], dtype=np.uint32), size=4 * run
    )
    runs = np.sort(x.reshape(4, run), axis=1).reshape(-1)
    np.testing.assert_array_equal(np.asarray(gst.sort_full(runs)),
                                  np.sort(x))
