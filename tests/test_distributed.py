"""Distributed sort over the 8-device virtual CPU mesh.

Validates both exchange strategies against the CPU oracle at widths 8 and
16 (the reference's benchmark configs, benchmark.go:139-156) on odd sizes,
plus the round invariant and overflow detection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from gpu_radix_sort_tpu.parallel import exchange as ex
from gpu_radix_sort_tpu.parallel import distributed, key_mesh
from gpu_radix_sort_tpu.utils.keygen import Pcg32


def _mesh():
    return key_mesh(jax.devices("cpu"))


@pytest.mark.parametrize("exchange", ["gather", "alltoall", "overflow"])
@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("n", [1111, 4099, 1 << 15])
def test_sort_distributed_exact(exchange, width, n):
    keys = Pcg32().fill(n)
    out = distributed.sort_distributed(
        keys, mesh=_mesh(), width=width, exchange=exchange
    )
    np.testing.assert_array_equal(out, np.sort(keys))


@pytest.mark.parametrize("exchange", ["gather", "alltoall", "overflow"])
def test_round_invariant(exchange):
    """After round r the global array is stably sorted by bits
    [0, (r+1)*width) — the reference's loop invariant (distrib.go:119)."""
    mesh = _mesh()
    width = 8
    n = 1 << 13
    keys = Pcg32().fill(n)
    n_local = n // 8

    sharding = NamedSharding(mesh, P("x"))
    dev = jax.device_put(keys, sharding)
    if exchange == "overflow":
        capacity = ex.overflow_capacities(n_local, 8)
    else:
        capacity = ex.default_capacity(n_local, 8, 1.25)

    state = dev
    for step in range(2):
        def round_(local):
            out, ovf = distributed._round_fn(
                local,
                offset=step * width,
                width=width,
                axis="x",
                exchange=exchange,
                capacity=capacity,
                strategy="xla",
            )
            return out, jax.lax.psum(ovf.astype(jnp.int32), "x")

        fn = shard_map(round_, mesh=mesh, in_specs=P("x"), out_specs=(P("x"), P()))
        state, ovf = jax.jit(fn)(state)
        assert not bool(np.any(np.asarray(ovf)))
        got = np.asarray(jax.device_get(state))
        bits = (step + 1) * width
        digits = keys & ((1 << bits) - 1)
        want = keys[np.argsort(digits, kind="stable")]
        np.testing.assert_array_equal(got, want)


def test_overflow_detected():
    # All keys identical -> every element targets one chip's range window;
    # with capacity ~n/P the alltoall must overflow and report it.
    n = 1 << 12
    keys = np.full(n, 7, dtype=np.uint32)
    with pytest.raises(distributed.OverflowError_):
        distributed.sort_distributed(
            keys, mesh=_mesh(), width=8, exchange="alltoall", capacity_factor=1.0
        )
    # gather strategy handles it exactly.
    out = distributed.sort_distributed(keys, mesh=_mesh(), width=8, exchange="gather")
    np.testing.assert_array_equal(out, keys)


def test_skewed_data_gather_exact():
    from gpu_radix_sort_tpu.utils.keygen import generate_zipf_keys

    keys = generate_zipf_keys(1 << 14, alpha=1.05, seed=9)
    out = distributed.sort_distributed(keys, mesh=_mesh(), width=8, exchange="gather")
    np.testing.assert_array_equal(out, np.sort(keys))


def test_nondivisible_sizes_padded():
    for n in (1, 7, 8, 9, 1023):
        keys = Pcg32().fill(n)
        out = distributed.sort_distributed(keys, mesh=_mesh(), width=8)
        np.testing.assert_array_equal(out, np.sort(keys))


def test_overflow_exchange_skew_detected():
    """All-equal keys: every chip's shard targets one peer; the two-pass
    exchange must flag overflow (explicit), and auto mode must still sort
    via its documented fallback path."""
    keys = np.full(1 << 13, 0xABCD0123, dtype=np.uint32)
    with pytest.raises(distributed.OverflowError_):
        distributed.sort_distributed(
            keys, mesh=_mesh(), width=8, exchange="overflow"
        )


def test_overflow_exchange_waste_bound():
    """The point of the two-pass exchange: slot bytes per round shrink from
    cf * n to n + P * C_ov."""
    n_local, nchips = 1 << 16, 8
    c0, c_ov = ex.overflow_capacities(n_local, nchips)
    single = ex.default_capacity(n_local, nchips, 1.5)
    two_pass_slots = nchips * (c0 + c_ov)
    single_slots = nchips * single
    assert two_pass_slots < 0.85 * single_slots
    assert c0 == -(-n_local // nchips)  # factor exactly 1.0


def test_destination_math_beyond_2e31():
    """x64 metadata math for n_global >= 2^31 (the >=4B-row regime): run
    starts and slice counts must come out exact where int32 would wrap.
    Oracle: Python big-int arithmetic on the same (P, D) counts."""
    P_, D = 4, 16
    per = (1 << 30) + 12_345  # n_global = 4*per > 2^32
    rng = np.random.default_rng(3)
    counts = rng.multinomial(per, [1 / D] * D, size=P_).astype(np.int64)

    with jax.enable_x64():
        S = np.asarray(ex._run_starts_global(jnp.asarray(counts)))
        assert S.dtype == np.int64

        # Oracle in pure Python ints
        totals = counts.sum(axis=0)
        base = np.concatenate([[0], np.cumsum(totals)[:-1]])
        off = np.cumsum(counts, axis=0) - counts
        want_S = base[None, :] + off
        np.testing.assert_array_equal(S, want_S)
        assert int(S.max()) > 2**31  # the regime int32 cannot represent

        # slice counts at a > 2^31 bound: how many of chip 1's elements land
        # below the bound
        bound = 3 * (1 << 30)  # 3.2e9-ish
        got = int(
            ex._slice_counts(
                jnp.asarray(want_S[1]), jnp.asarray(counts[1]), jnp.int64(bound)
            )
        )
        want = sum(
            max(0, min(bound - int(s), int(c)))
            for s, c in zip(want_S[1], counts[1])
        )
        assert got == want


def test_invalid_width_rejected():
    with pytest.raises(ValueError):
        distributed.sort_distributed(Pcg32().fill(64), mesh=_mesh(), width=5)


def test_all_equal_keys():
    """All-equal keys are the fixed-capacity worst case (each chip's whole
    shard is destined for one peer): explicit alltoall must surface the
    overflow; auto must fall back to the exact gather exchange."""
    keys = np.full(4096, 0xDEADBEEF, dtype=np.uint32)
    with pytest.raises(distributed.OverflowError_):
        distributed.sort_distributed(
            keys, mesh=_mesh(), width=8, exchange="alltoall"
        )
    out = distributed.sort_distributed(
        keys, mesh=_mesh(), width=8, exchange="auto"
    )
    np.testing.assert_array_equal(out, keys)
    # Above the auto size threshold the first attempt really is alltoall;
    # the overflow retry must recover exactly.
    big = np.full((1 << 20) + 64, 7, dtype=np.uint32)
    out = distributed.sort_distributed(
        big, mesh=_mesh(), width=16, exchange="auto"
    )
    np.testing.assert_array_equal(out, big)


def test_zipf_skew_alltoall_or_explicit_overflow():
    """Zipf keys through the capacity-bounded exchange either sort exactly
    or raise the explicit overflow error — never silently corrupt."""
    from gpu_radix_sort_tpu.utils.keygen import generate_zipf_keys

    keys = generate_zipf_keys(1 << 14, alpha=1.3, seed=2)
    try:
        out = distributed.sort_distributed(
            keys, mesh=_mesh(), width=8, exchange="alltoall",
            capacity_factor=1.25,
        )
    except distributed.OverflowError_:
        out = distributed.sort_distributed(
            keys, mesh=_mesh(), width=8, exchange="gather"
        )
    np.testing.assert_array_equal(out, np.sort(keys))


# ---------------------------------------------------------------------------
# Fused round loop (reassembly + next local sort = one rotated-value sort)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exchange", ["alltoall", "overflow"])
def test_fused_rounds_bit_identical(exchange):
    """The fused LSD loop (default for width<=8) must produce bit-identical
    output to the unfused loop for every eligible exchange."""
    mesh = _mesh()
    nchips = 8
    n = 1 << 13
    keys = Pcg32(31).fill(n)
    dev = jax.device_put(keys, NamedSharding(mesh, P("x")))
    outs = []
    for fuse in (True, False):
        fn = distributed.build_distributed_sort(
            mesh, n // nchips, width=8, exchange=exchange,
            strategy="xla", fuse_rounds=fuse,
        )
        out, ovf = fn(dev)
        assert int(ovf) == 0
        outs.append(np.asarray(jax.device_get(out)))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], np.sort(keys))


def test_fused_rounds_duplicate_stability():
    """Heavy duplicates: the rotated-value fusion must still produce the
    exact sorted multiset (equal keys are where a sentinel-tie or
    rotation-order slip would show up)."""
    rng = np.random.default_rng(3)
    n = 1 << 13
    # every key repeated 4x, shuffled: abundant equal-key AND equal-digit
    # ties in every round, but digit histograms stay uniform so the
    # capacity-bounded exchange never overflows (a concentrated-digit
    # distribution would overflow alltoall by design — that axis is
    # covered by test_overflow_detected / the gather tests).
    keys = np.tile(Pcg32(5).fill(n // 4), 4)
    rng.shuffle(keys)
    out = distributed.sort_distributed(
        keys, mesh=_mesh(), width=8, exchange="alltoall"
    )
    np.testing.assert_array_equal(out, np.sort(keys))


def test_fused_rounds_rejects_bad_combo():
    with pytest.raises(ValueError, match="fuse_rounds"):
        distributed.build_distributed_sort(
            _mesh(), 1 << 10, width=8, exchange="gather", fuse_rounds=True
        )


def test_fused_rounds_width16():
    """Width 16 fuses too under the rotated-value formulation (the old
    composite key needed 2*width+1 <= 32 and rejected it)."""
    n = 1 << 13
    keys = Pcg32(77).fill(n)
    dev = jax.device_put(keys, NamedSharding(_mesh(), P("x")))
    fn = distributed.build_distributed_sort(
        _mesh(), n // 8, width=16, exchange="alltoall",
        strategy="xla", fuse_rounds=True, capacity_factor=1.6,
    )
    out, ovf = fn(dev)
    assert int(ovf) == 0
    np.testing.assert_array_equal(np.asarray(jax.device_get(out)),
                                  np.sort(keys))


def test_fused_rounds_fuzz_vs_oracle():
    """Seeded fuzz over widths, sizes, distributions: fused alltoall LSD
    (the production default) must equal np.sort for every draw — guards
    the rotated-key math and the sentinel/validity handling."""
    rng = np.random.default_rng(1234)
    mesh = _mesh()
    for trial in range(6):
        width = int(rng.choice([2, 4, 8]))
        n = int(rng.integers(1 << 10, 1 << 14))
        kind = trial % 3
        if kind == 0:
            keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
        elif kind == 1:  # few distinct values, shuffled (tie storm)
            keys = rng.choice(
                rng.integers(0, 1 << 32, 7, dtype=np.uint32), size=n
            )
        else:  # runs of sorted data with full-range extremes
            keys = np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint32))
            keys[:: max(n // 17, 1)] = 0xFFFFFFFF
            keys[1 :: max(n // 13, 1)] = 0
        try:
            # explicit alltoall: exchange="auto" resolves to the UNFUSED
            # gather path at these sizes, which would leave the fused
            # loop's rotated-key math entirely unexercised by this fuzz
            out = distributed.sort_distributed(
                keys, mesh=mesh, width=width, exchange="alltoall",
                capacity_factor=2.0,
            )
        except distributed.OverflowError_:
            continue  # capacity overflow is legal for skewed draws
        np.testing.assert_array_equal(
            out, np.sort(keys), err_msg=f"trial={trial} width={width} n={n}"
        )


def test_sort_distributed_typed_keys():
    """int32 / float32 keys through the mesh LSD and PSRS paths via the
    order-preserving u32 bijection (encoded host-side)."""
    from gpu_radix_sort_tpu.parallel import sort_distributed_sample

    rng = np.random.default_rng(4)
    i32 = rng.integers(-(1 << 31), 1 << 31, 1 << 13, dtype=np.int64).astype(
        np.int32
    )
    out = distributed.sort_distributed(i32, mesh=_mesh(), width=8)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, np.sort(i32))

    f32 = rng.standard_normal(1 << 13).astype(np.float32)
    f32[:3] = [-np.inf, np.inf, -0.0]
    out = sort_distributed_sample(f32, mesh=_mesh())
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, np.sort(f32))
