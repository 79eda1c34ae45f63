"""Deterministic cross-path fuzz: every execution path must agree with the
numpy oracle (and hence with each other) across randomized sizes, widths,
and key distributions."""

import numpy as np
import pytest

import gpu_radix_sort_tpu.utils.checks as checks
from gpu_radix_sort_tpu.data import MemArrayFactory
from gpu_radix_sort_tpu.parallel import (
    local_distrib_worker,
    sort_distrib_from_raw,
    sort_distributed,
    sort_distributed_sample,
)


def _cases(n_cases=12, seed=99):
    rng = np.random.default_rng(seed)
    for i in range(n_cases):
        n = int(rng.integers(1, 20_000))
        kind = rng.choice(["uniform", "dupes", "sorted", "reverse", "const",
                           "extremes"])
        if kind == "uniform":
            keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        elif kind == "dupes":
            keys = rng.integers(0, 8, size=n).astype(np.uint32)
        elif kind == "sorted":
            keys = np.sort(rng.integers(0, 2**32, size=n, dtype=np.uint32))
        elif kind == "reverse":
            keys = np.sort(rng.integers(0, 2**32, size=n, dtype=np.uint32))[::-1].copy()
        elif kind == "const":
            keys = np.full(n, rng.integers(0, 2**32), dtype=np.uint32)
        else:
            keys = rng.choice(
                np.array([0, 1, 0x7FFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF],
                         dtype=np.uint32), size=n)
        yield i, kind, keys


@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: f"{c[0]}-{c[1]}")
def test_paths_agree_with_oracle(case):
    i, kind, keys = case
    want = np.sort(keys)

    import jax

    from gpu_radix_sort_tpu.ops.radix_sort import sort_full

    got = np.asarray(jax.device_get(sort_full(jax.device_put(keys))))
    np.testing.assert_array_equal(got, want, err_msg=f"single {kind}")

    got = sort_distributed(keys, width=16)
    np.testing.assert_array_equal(got, want, err_msg=f"mesh {kind}")

    got = sort_distributed_sample(keys)
    np.testing.assert_array_equal(got, want, err_msg=f"sample {kind}")

    if i % 3 == 0:  # storage path is slower; sample it
        got = sort_distrib_from_raw(
            keys, f"fuzz{i}", MemArrayFactory(), local_distrib_worker,
            width=8, nworker=3,
        )
        np.testing.assert_array_equal(got, want, err_msg=f"storage {kind}")

    if i % 3 == 1:  # kv storage rows: payload carries the stability witness
        from gpu_radix_sort_tpu.parallel import sort_distrib_from_raw_kv

        n = keys.size
        payload = (
            np.arange(n, dtype=np.uint32).view(np.uint8).reshape(n, 4)
        )
        gk, gp = sort_distrib_from_raw_kv(
            keys, payload, f"fuzzkv{i}", MemArrayFactory(),
            width=8, nworker=2,
        )
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(gk, keys[order], err_msg=f"kv {kind}")
        np.testing.assert_array_equal(
            gp, payload[order], err_msg=f"kv payload {kind}"
        )

    if i % 3 == 2:  # two-pass overflow exchange (falls back explicitly)
        from gpu_radix_sort_tpu.parallel.distributed import OverflowError_

        try:
            got = sort_distributed(keys, width=8, exchange="overflow")
            np.testing.assert_array_equal(
                got, want, err_msg=f"overflow {kind}"
            )
        except OverflowError_:
            pass  # degenerate distributions legitimately overflow


@pytest.mark.parametrize(
    "case", list(_cases(8, seed=123)), ids=lambda c: f"{c[0]}-{c[1]}"
)
def test_radix_engine_fuzz(case):
    """The stable digit sort (sort_by_digits) against the stable oracle,
    randomized offsets/widths per case — the seeds that fuzzed the removed
    binning kernel."""
    i, kind, keys = case
    rng = np.random.default_rng(1000 + i)
    width = int(rng.choice([2, 3, 4]))
    offset = int(rng.integers(0, 32 - width))
    from gpu_radix_sort_tpu.ops.radix_sort import sort_by_digits

    got = np.asarray(sort_by_digits(keys, offset, width))
    d = (keys >> np.uint32(offset)) & np.uint32((1 << width) - 1)
    np.testing.assert_array_equal(
        got, keys[np.argsort(d, kind="stable")],
        err_msg=f"radix {kind} o={offset} w={width}",
    )
