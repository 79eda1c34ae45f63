"""The (width, n) cases of the removed remote-DMA exchanges, carried onto
the collective exchanges that remain (``alltoall`` and ``overflow``), on
the full 8-device virtual mesh and on a 4-device sub-mesh (the four-card
layout ``chip_smoke.py --mesh 4`` runs on GPUs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from gpu_radix_sort_tpu.parallel import distributed, key_mesh
from gpu_radix_sort_tpu.parallel import exchange as ex
from gpu_radix_sort_tpu.utils.keygen import Pcg32

EXCHANGES = ["alltoall", "overflow"]
MESH_SIZES = [8, 4]


def _mesh(p):
    return key_mesh(jax.devices("cpu")[:p])


def _round_keys(dist, n):
    if dist == "uniform":
        return Pcg32().fill(n)
    if dist == "dupes":
        return np.random.default_rng(5).integers(0, 4, size=n).astype(
            np.uint32)
    return np.sort(Pcg32().fill(n))


@pytest.mark.parametrize("p", MESH_SIZES)
@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("dist", ["uniform", "dupes", "sorted"])
def test_exchange_round_exact_or_flagged(dist, exchange, p):
    """One stable width-8 round at offset 8 equals the stable digit oracle;
    where the capacity-bounded exchange cannot hold the skew (all keys in
    one digit) it must say so, never return a wrong order."""
    mesh = _mesh(p)
    n = 1 << 13
    keys = _round_keys(dist, n)
    n_local = n // p
    capacity = (ex.overflow_capacities(n_local, p) if exchange == "overflow"
                else ex.default_capacity(n_local, p, 1.25))

    def round_(local):
        out, ovf = distributed._round_fn(
            local, offset=8, width=8, axis="x", exchange=exchange,
            capacity=capacity, strategy="xla",
        )
        return out, jax.lax.psum(ovf.astype(jnp.int32), "x")

    fn = jax.jit(shard_map(round_, mesh=mesh, in_specs=P("x"),
                           out_specs=(P("x"), P())))
    got, ovf = fn(jax.device_put(keys, NamedSharding(mesh, P("x"))))
    if dist == "dupes":
        assert int(ovf) > 0  # every key has digit 0: one peer gets all
        return
    assert int(ovf) == 0
    digits = (keys >> 8) & 0xFF
    want = keys[np.argsort(digits, kind="stable")]
    np.testing.assert_array_equal(np.asarray(jax.device_get(got)), want)


@pytest.mark.parametrize("p", MESH_SIZES)
@pytest.mark.parametrize(
    "width,n,exchange",
    [(w, n, e) for (w, n) in [(8, 1111), (8, 1 << 13), (16, 1 << 13),
                              (8, 1 << 14)] for e in EXCHANGES]
    # width 4: 16 digit buckets over 8 shards overflow the overflow
    # exchange's static slot; the capacity-factor exchange carries it
    + [(4, 1 << 14, "alltoall")],
)
def test_full_sort_exact(width, n, exchange, p):
    """Full LSD sort (padded non-divisible sizes, the width-16 65536-bin
    metadata path, and width 4) exact against np.sort."""
    keys = Pcg32().fill(n)
    out = distributed.sort_distributed(
        keys, mesh=_mesh(p), width=width, exchange=exchange,
        capacity_factor=1.6,
    )
    np.testing.assert_array_equal(out, np.sort(keys))


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_fused_rounds_bit_identical_four_devices(exchange):
    mesh = _mesh(4)
    n = 1 << 13
    keys = Pcg32(31).fill(n)
    dev = jax.device_put(keys, NamedSharding(mesh, P("x")))
    outs = []
    for fuse in (True, False):
        fn = distributed.build_distributed_sort(
            mesh, n // 4, width=8, exchange=exchange, strategy="xla",
            fuse_rounds=fuse,
        )
        out, ovf = fn(dev)
        assert int(ovf) == 0
        outs.append(np.asarray(jax.device_get(out)))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], np.sort(keys))


@pytest.mark.parametrize("p", MESH_SIZES)
def test_all_equal_keys_auto_exchange(p):
    """The remote-DMA exchange's degenerate case (every row to one peer):
    the default exchange sorts it exactly (gather, or alltoall with the
    gather retry)."""
    keys = np.full(1 << 14, 0xDEADBEEF, dtype=np.uint32)
    out = distributed.sort_distributed(keys, mesh=_mesh(p), width=8)
    np.testing.assert_array_equal(out, keys)
