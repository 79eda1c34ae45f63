"""Distributed radix sort over a device mesh.

Capability mirror of the reference's bulk-synchronous distributed sort
(benchmark/pkg/sort/distrib.go:90-248: ``nstep = 32/width`` rounds, each
round = per-worker partial sort + bucket repartition), re-architected for
SPMD:

  * workers     -> mesh shards (shard_map over axis "x"); nworker is the
                   mesh size, not a hard-coded 2 (distrib.go:107).
  * repartition -> an all-to-all collective (parallel/exchange.py; XLA
                   hands it to NCCL on GPUs) instead of the STRIDED
                   BucketReader over a shared filesystem.
  * bucket metadata -> device arrays exchanged by all-gather, not JSON.

Round invariant: after round r the global array (in shard-major linear
order) is A sort by bits [0, (r+1)*width).  The unfused loop maintains the
reference's STABLE version of that invariant (within-digit ties keep
arrival order, distrib.go:119-176); the default fused loop orders ties by
value instead (rotated-value sorts, :func:`_fused_sort_shard`), which is
keys-only-equivalent — the final output is the unique sorted multiset
either way, bitwise equal to the reference sort.  Anything that OBSERVES
intermediate rounds (payload variants, resume into the unfused loop) must
use ``fuse_rounds=False`` for the stable intermediate contract.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.bits import KEY_BITS, rotr32 as _rotr32
from ..ops.radix_sort import check_strategy
from . import exchange as ex
from .mesh import KEY_AXIS, key_mesh

_VALID_EXCHANGE = ("auto", "alltoall", "overflow", "gather")
# Exchange names of removed remote-DMA kernels: asking for one is an
# error, never a silent fallback to another exchange.
REMOVED_EXCHANGES = ("rdma", "rdma_overlap")


def check_exchange(exchange: str) -> str:
    if exchange in REMOVED_EXCHANGES:
        raise ValueError(
            f"exchange {exchange!r} named a remote-DMA kernel that has been "
            f"removed; use one of {_VALID_EXCHANGE}"
        )
    if exchange not in _VALID_EXCHANGE:
        raise ValueError(f"exchange must be one of {_VALID_EXCHANGE}")
    return exchange


def _round_fn(local_keys, *, offset, width, axis, exchange, capacity, strategy):
    if exchange == "gather":
        return ex.exchange_round_gather(
            local_keys, offset, width, axis, strategy=strategy
        )
    if exchange == "overflow":
        c0, c_ov = capacity
        return ex.exchange_round_alltoall_overflow(
            local_keys, offset, width, axis, c0, c_ov, strategy=strategy
        )
    return ex.exchange_round_alltoall(
        local_keys, offset, width, axis, capacity, strategy=strategy
    )


def _exchange_raw(sorted_local, *, offset, width, axis, exchange, capacity):
    """Round k's exchange on an already digit-sorted shard, WITHOUT the
    reassembly sort: returns (tags, flat, overflowed) — see
    exchange.exchange_round_alltoall_raw for the contract."""
    if exchange == "overflow":
        c0, c_ov = capacity
        return ex.exchange_round_alltoall_overflow_raw(
            sorted_local, offset, width, axis, c0, c_ov
        )
    return ex.exchange_round_alltoall_raw(
        sorted_local, offset, width, axis, capacity
    )




def _fused_sort_shard(local_keys, *, width, axis, exchange, capacity,
                      strategy, nsteps):
    """LSD loop where every round is ONE keys-only full sort of a
    bit-ROTATED key (the round-3 successor of the composite-kv fusion).

    Round k's required shard order is (digit_k, bits [0, k*width), high
    bits) — lexicographically that is exactly the plain ascending order of
    z = rotr(x, (k+1)*width), a pure VALUE function.  Correctness by
    induction on "each shard's multiset equals its slice of the globally
    bits-[0,(k+1)w)-sorted array": within a digit the exchange's
    (src, rank) receive order is then nondecreasing in the lower bits, so
    the capacity cuts land on slices of the next invariant's order;
    arrival order among FULLY tied values never matters because every
    subsequent round sorts by value alone.  Two wins over the composite
    formulation it replaces:

      * the per-round sort is keys-only (one sort_full, which XLA hands
        to CUB's radix sort on GPUs) instead of a pair sort;
      * no composite bit budget — any width dividing 32 fuses, including
        16 (the composite needed 2*width+1 <= 32).

    Invalid slack slots are forced to 0xFFFFFFFF before each sort and the
    first n_local survivors taken: a sentinel can only tie with a REAL
    0xFFFFFFFF rotated key, whose value is identical, so the kept multiset
    is exact for full-range keys (no sentinel-key semantics leak).

    Same invariants, same overflow semantics, same exchanges; the
    composed output is bit-identical to the unfused loop (tested)."""
    from ..ops.radix_sort import sort_full

    n_local = local_keys.shape[0]
    D = jnp.uint32(1 << width)
    overflow = jnp.int32(0)
    FF = jnp.uint32(0xFFFFFFFF)

    zs = sort_full(_rotr32(local_keys, width), strategy=strategy)
    sorted_local = _rotr32(zs, 32 - width)
    tags = flat = None
    for step in range(nsteps):
        if step > 0:
            rot = ((step + 1) * width) % 32
            z = jnp.where(tags == D, FF, _rotr32(flat, rot))
            zs = sort_full(z, strategy=strategy)
            sorted_local = _rotr32(zs, 32 - rot)[:n_local]
        tags, flat, ovf = _exchange_raw(
            sorted_local,
            offset=step * width,
            width=width,
            axis=axis,
            exchange=exchange,
            capacity=capacity,
        )
        overflow = overflow + ovf.astype(jnp.int32)
    # final round's rotation is the identity: a plain value sort reassembles
    out = sort_full(
        jnp.where(tags == D, FF, flat), strategy=strategy
    )[:n_local]
    return out, lax.psum(overflow, axis)


def build_distributed_sort(
    mesh,
    n_local: int,
    *,
    width: int = 8,
    exchange: str = "auto",
    capacity_factor: float = 1.25,
    strategy: str | None = None,
    axis: str = KEY_AXIS,
    fuse_rounds: bool | None = None,
):
    """Compile-ready distributed full sort.

    Returns ``fn(keys_sharded) -> (sorted_sharded, overflow_count)`` where
    keys has global shape (P * n_local,) sharded over ``axis``.  The round
    loop is the reference's ``nstep = 32/width`` structure
    (distrib.go:109-176) with the exchange fused into each round.

    ``fuse_rounds`` (default auto: on for the alltoall / overflow
    exchanges, any width) collapses each round's reassembly sort and the
    next round's local digit sort into one keys-only rotated-value sort —
    see :func:`_fused_sort_shard`.  Output is bit-identical either way.
    """
    if KEY_BITS % width or width > 16:
        # width=32 would need 2^32 digit-count bins and a sentinel digit
        # beyond uint32 — reject up front (use sort_full for one chip).
        raise ValueError(
            f"width {width} must divide {KEY_BITS} and be <= 16"
        )
    check_exchange(exchange)
    check_strategy(strategy)
    nchips = mesh.shape[axis]
    if exchange == "auto":
        # gather is exact and fastest for small shards; alltoall scales.
        exchange = "gather" if n_local * nchips <= (1 << 20) else "alltoall"
    if exchange == "overflow":
        capacity = ex.overflow_capacities(n_local, nchips)
    else:
        capacity = ex.default_capacity(n_local, nchips, capacity_factor)
    nsteps = KEY_BITS // width
    if fuse_rounds is None:
        fuse_rounds = exchange in ("alltoall", "overflow")
    elif fuse_rounds and exchange not in ("alltoall", "overflow"):
        raise ValueError(
            "fuse_rounds requires exchange in ('alltoall', 'overflow'); "
            f"got exchange={exchange!r}"
        )

    if fuse_rounds:
        def sort_shard(local_keys):
            return _fused_sort_shard(
                local_keys,
                width=width,
                axis=axis,
                exchange=exchange,
                capacity=capacity,
                strategy=strategy,
                nsteps=nsteps,
            )
    else:
        def sort_shard(local_keys):
            overflow = jnp.int32(0)
            for step in range(nsteps):
                local_keys, ovf = _round_fn(
                    local_keys,
                    offset=step * width,
                    width=width,
                    axis=axis,
                    exchange=exchange,
                    capacity=capacity,
                    strategy=strategy,
                )
                overflow = overflow + ovf.astype(jnp.int32)
            return local_keys, lax.psum(overflow, axis)

    fn = shard_map(
        sort_shard,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=(P(axis), P()),
    )
    return jax.jit(fn)


class OverflowError_(RuntimeError):
    pass


def sort_distributed(
    keys,
    *,
    mesh=None,
    width: int = 8,
    exchange: str = "auto",
    capacity_factor: float = 1.25,
    strategy: str | None = None,
) -> np.ndarray:
    """Host-facing distributed full sort (reference: SortDistribFromRaw,
    distrib.go:183-248): pads to the mesh, shards, runs 32/width rounds,
    returns the linearized sorted uint32 array.

    Raises if the capacity-bounded exchange overflowed (use a larger
    ``capacity_factor``, the ``"gather"`` exchange, or splitter-balanced
    partitioning for heavily skewed data).

    int32 / float32 keys are accepted via the order-preserving uint32
    bijection (ops/bits.py — IEEE-754 totalOrder for floats), encoded
    host-side before sharding.
    """
    keys = np.asarray(keys)
    if keys.dtype in (np.int32, np.float32):
        from ..ops.bits import decode_ordered_np, encode_ordered_np

        out = sort_distributed(
            encode_ordered_np(keys), mesh=mesh, width=width,
            exchange=exchange, capacity_factor=capacity_factor,
            strategy=strategy,
        )
        return decode_ordered_np(out, keys.dtype)
    mesh = mesh or key_mesh()
    nchips = mesh.shape[KEY_AXIS]
    keys = np.asarray(keys, dtype=np.uint32)
    n = keys.size
    n_local = max(-(-n // nchips), 1)
    n_pad = n_local * nchips
    if n_pad * 1 >= (1 << 31) and not jax.config.jax_enable_x64:
        raise ValueError(
            "global size >= 2^31 requires jax_enable_x64 for destination "
            "index math; call jax.config.update('jax_enable_x64', True)"
        )
    padded = np.full(n_pad, 0xFFFFFFFF, dtype=np.uint32)
    padded[:n] = keys

    sharding = NamedSharding(mesh, P(KEY_AXIS))
    dev_keys = jax.device_put(padded, sharding)
    fn = build_distributed_sort(
        mesh,
        n_local,
        width=width,
        exchange=exchange,
        capacity_factor=capacity_factor,
        strategy=strategy,
    )
    out, overflow = fn(dev_keys)
    if int(overflow) > 0:
        # Degenerate distributions (e.g. all-equal keys: every chip's whole
        # shard stays on one peer) exceed any fixed per-peer capacity.  In
        # "auto" mode fall back to the exact gather exchange; an explicitly
        # requested alltoall surfaces the overflow to the caller.
        if exchange == "auto":
            fn = build_distributed_sort(
                mesh, n_local, width=width, exchange="gather",
                strategy=strategy,
            )
            out, overflow = fn(dev_keys)
            assert int(overflow) == 0
        else:
            raise OverflowError_(
                f"all-to-all capacity overflowed in {int(overflow)} "
                "round-chips; increase capacity_factor or use "
                "exchange='gather'"
            )
    return np.asarray(jax.device_get(out))[:n]
