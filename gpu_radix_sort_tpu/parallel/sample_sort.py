"""Distributed sample sort (PSRS) — the performance-mode distributed sort.

The reference's distributed algorithm is LSD radix with 32/width bulk-
synchronous rounds (benchmark/pkg/sort/distrib.go:109); each round costs a
full local sort plus a full-data exchange.  Parallel Sorting by Regular
Sampling needs ONE local sort, ONE splitter-partitioned all-to-all and ONE
local merge — ~4x less sort work than the width-8 LSD structure, with
sampled splitters bounding partition skew (the BASELINE.json requirement).

Phases (inside shard_map over mesh axis "x"):
  1. local full sort;
  2. regular sampling on COMPOSITE keys: P local quantiles (key, local
     rank, chip), all-gathered, lex-sorted; global quantiles of the P*P
     candidates become the P-1 composite splitters.  Composites are always
     DISTINCT, so the classic PSRS balance guarantee (no partition exceeds
     ~2 n/P) holds for ANY key distribution — duplicates included;
  3. composite splitter boundaries via two searchsorteds + closed-form tie
     counts on the sorted shard -> P contiguous slices.  The self-destined
     slice BYPASSES the collective (stays local, no capacity constraint —
     sorted/self-destined inputs move zero bytes); the rest rides a
     capacity-bounded all_to_all.  Overflow is detected, never silent; it
     now requires adversarial cross-chip PLACEMENT (one chip holding >
     capacity keys destined to one other chip), not mere duplicates;
  4. reassembly: one sort over the received buffer plus the masked
     self-destined slice (pads carry the max key and are truncated by the
     valid count; the kv variant sorts by explicit (key, validity, source
     chip, source rank) to keep global stability).

Tie-break order differs by variant — keys-only splits ties by (rank,
chip), round-robining each hot key's ties across ALL chips so per-pair
traffic stays ~even/P for any duplicate mass (equal keys are
interchangeable in a keys-only sort, so any tie partition is exact).
The kv variant must reproduce the stable order (key, chip, rank), so ties
split by (chip, rank); all-equal inputs become self-destined there
(handled by the diagonal bypass), and only duplicate mass POURED ACROSS
chips onto one destination can still overflow into the fallback.

Output shards are ragged (counts returned per chip); the host wrapper
linearizes exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.bits import KEY_DTYPE
from .exchange import PAD_KEY, send_windows
from .mesh import KEY_AXIS, key_mesh

# Payload lanes up to this many ride XLA sorts as extra operands; wider
# payloads use permutation gathers.
from ..ops.radix_sort import MAX_SORT_LANES  # single source of truth


# Capacity of one (src chip -> dst chip) transfer slot — same policy as
# the LSD exchange; one implementation so headroom changes can't drift.
from .exchange import default_capacity as default_pair_capacity


# Reassembly of a removed merge-network kernel: asking for it is an error.
REMOVED_REASSEMBLIES = ("merge",)


def check_reassembly(reassembly: str) -> str:
    if reassembly in REMOVED_REASSEMBLIES:
        raise ValueError(
            f"reassembly {reassembly!r} named a merge-network kernel that "
            "has been removed; use reassembly='sort'"
        )
    if reassembly != "sort":
        raise ValueError(f"reassembly must be 'sort', got {reassembly!r}")
    return reassembly


def _composite_splitters(s, *, axis, order: str):
    """P-1 composite splitters from regular sampling of the sorted shard.

    Each candidate is the triple (key, local sorted rank, chip) of an
    actual element; ``order`` is the tie-break lex order within equal keys:
    "rank_chip" (keys-only: round-robins each key's ties across chips) or
    "chip_rank" (kv: the stable global order).  Composites are distinct, so
    regular sampling's balance bound holds for any key distribution.
    Returns (spl_key, spl_rank, spl_chip), each (P-1,).
    """
    P_ = lax.axis_size(axis)
    n = s.shape[0]
    stride = max(n // P_, 1)
    pos = jnp.arange(P_, dtype=jnp.int32) * stride
    all_samples = lax.all_gather(s[pos], axis)  # (P, P): [chip, m]
    cand_k = all_samples.reshape(-1)
    cand_r = jnp.tile(pos, P_)
    cand_c = jnp.repeat(jnp.arange(P_, dtype=jnp.int32), P_)
    if order == "rank_chip":
        sk, sr, sc = lax.sort((cand_k, cand_r, cand_c), num_keys=3)
    else:
        sk, sc, sr = lax.sort((cand_k, cand_c, cand_r), num_keys=3)
    idx = jnp.arange(1, P_, dtype=jnp.int32) * P_
    return sk[idx], sr[idx], sc[idx]


def _composite_bounds(s, spl_k, spl_r, spl_c, my, order: str):
    """Per-splitter local boundary: the number of local elements whose
    composite (key, rank=local index, chip=my) precedes the splitter.
    Closed form over the tie run [lo, hi) — two searchsorteds, no
    per-element composite materialization."""
    lo = jnp.searchsorted(s, spl_k, side="left").astype(jnp.int32)
    hi = jnp.searchsorted(s, spl_k, side="right").astype(jnp.int32)
    if order == "rank_chip":
        # (rank, chip) < (r_m, c_m): rank < r_m, plus rank == r_m with an
        # earlier chip (local ranks of the tie run ARE the indices [lo, hi)).
        tie = jnp.clip(spl_r - lo, 0, hi - lo) + (
            (my < spl_c) & (spl_r >= lo) & (spl_r < hi)
        ).astype(jnp.int32)
    else:
        # (chip, rank) < (c_m, r_m): earlier chips contribute their whole
        # tie run, the splitter's own chip its rank prefix.
        tie = jnp.where(
            my < spl_c,
            hi - lo,
            jnp.where(my == spl_c, jnp.clip(spl_r - lo, 0, hi - lo), 0),
        )
    return lo + tie


def _self_bypass(send_bounds, send_count, my, P_, capacity):
    """Diagonal-bypass bookkeeping: the self-destined slice never rides the
    collective, so it carries no capacity constraint.  Returns
    (offdiag_count, overflowed, self_lo, self_hi)."""
    peer = jnp.arange(P_, dtype=jnp.int32)
    offdiag = jnp.where(peer == my, 0, send_count)
    overflowed = jnp.any(offdiag > capacity)
    return offdiag, overflowed, send_bounds[my], send_bounds[my + 1]


def _sample_sort_shard(local_keys, *, axis, capacity):
    P_ = lax.axis_size(axis)
    my = lax.axis_index(axis)
    n = local_keys.shape[0]

    # PSRS's two keys-only full sorts are its whole compute cost.
    from ..ops.radix_sort import sort_full

    s = sort_full(local_keys.astype(KEY_DTYPE))

    spl = _composite_splitters(s, axis=axis, order="rank_chip")
    bounds = _composite_bounds(s, *spl, my, "rank_chip")
    send_bounds = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), bounds, jnp.full(1, n, jnp.int32)]
    )  # (P+1,)
    send_count = send_bounds[1:] - send_bounds[:-1]
    offdiag, overflowed, self_lo, self_hi = _self_bypass(
        send_bounds, send_count, my, P_, capacity
    )

    padded = jnp.concatenate([s, jnp.full((capacity,), PAD_KEY, KEY_DTYPE)])
    # (P, C) — rows unmasked; receiver masks by exact counts.
    send_keys = send_windows(padded, send_bounds[:-1], capacity)

    counts_mat = lax.all_gather(offdiag, axis)  # (P, P): [i, c] = i -> c
    recv_count = counts_mat[:, my]  # (P,) — 0 at my own row (bypassed)

    recv = lax.all_to_all(send_keys, axis, 0, 0, tiled=False)
    k_iota = lax.broadcasted_iota(jnp.int32, (P_, capacity), 1)
    masked = jnp.where(k_iota < recv_count[:, None], recv, PAD_KEY)
    # Self-destined slice, masked in place (contiguous in the shard).
    pos = jnp.arange(n, dtype=jnp.int32)
    self_buf = jnp.where((pos >= self_lo) & (pos < self_hi), s, PAD_KEY)
    merged = sort_full(
        jnp.concatenate([masked.reshape(-1), self_buf])
    )  # pads (max key) sort last
    total = recv_count.sum().astype(jnp.int32) + (self_hi - self_lo)
    return merged, total[None], lax.psum(overflowed.astype(jnp.int32), axis)


def build_sample_sort(
    mesh,
    n_local: int,
    *,
    capacity_factor: float = 1.5,
    axis: str = KEY_AXIS,
    reassembly: str = "sort",
):
    """Compile-ready distributed sample sort over ``axis``.

    Returns ``fn(keys) -> (padded_shards, shard_counts, overflow)`` where
    keys has global shape (P*n_local,) sharded over ``axis``; padded_shards
    has global shape (P * (P*C + n_local),) (per-chip sorted buffer incl.
    padding and the bypassed self slice), shard_counts (P,) gives each
    chip's valid prefix length.

    ``reassembly``: "sort", the only one — one sort_full over the received
    buffer.  The name of the removed merge-network reassembly raises.
    """
    check_reassembly(reassembly)
    nchips = mesh.shape[axis]
    capacity = default_pair_capacity(n_local, nchips, capacity_factor)
    fn = shard_map(
        lambda k: _sample_sort_shard(k, axis=axis, capacity=capacity),
        mesh=mesh,
        in_specs=P(axis),
        out_specs=(P(axis), P(axis), P()),
    )
    return jax.jit(fn), capacity


def _sample_sort_kv_shard(local_keys, local_vals, *, axis, capacity):
    """PSRS with payload rows riding the exchange.

    ``local_vals``: (n, W) uint32 lanes (the host wrapper packs arbitrary
    fixed-size byte payloads into lanes).  Stability: ties broken by
    (source chip, original local index), i.e. global input order — matching
    a stable single-chip kv sort of the linearized input.
    """
    P_ = lax.axis_size(axis)
    my = lax.axis_index(axis)
    n = local_keys.shape[0]
    W = local_vals.shape[1]

    # Narrow payloads ride the sort as extra operands; wide payloads are
    # moved by a permutation gather (sort compile time grows with operand
    # count).
    if 0 < W <= MAX_SORT_LANES:
        lanes = tuple(local_vals[:, w] for w in range(W))
        sorted_ops = lax.sort(
            (local_keys.astype(KEY_DTYPE), *lanes), num_keys=1, is_stable=True
        )
        s = sorted_ops[0]
        vals_s = jnp.stack(sorted_ops[1:], axis=1)
    else:
        idx = jnp.arange(n, dtype=jnp.uint32)
        s, order = lax.sort_key_val(
            local_keys.astype(KEY_DTYPE), idx, is_stable=True
        )
        vals_s = jnp.take(local_vals, order, axis=0)

    # Composite splitters in the STABLE order (key, chip, rank): the tie
    # partition must agree with the final output's tie order, or shard
    # concatenation would interleave ties out of global input order.
    spl = _composite_splitters(s, axis=axis, order="chip_rank")
    bounds = _composite_bounds(s, *spl, my, "chip_rank")
    send_bounds = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), bounds, jnp.full(1, n, jnp.int32)]
    )
    send_count = send_bounds[1:] - send_bounds[:-1]
    offdiag, overflowed, self_lo, self_hi = _self_bypass(
        send_bounds, send_count, my, P_, capacity
    )

    padded_k = jnp.concatenate([s, jnp.full((capacity,), PAD_KEY, KEY_DTYPE)])
    padded_v = jnp.concatenate(
        [vals_s, jnp.zeros((capacity, W), jnp.uint32)], axis=0
    )
    send_keys = send_windows(padded_k, send_bounds[:-1], capacity)  # (P, C)
    send_vals = send_windows(padded_v, send_bounds[:-1], capacity)  # (P, C, W)

    counts_mat = lax.all_gather(offdiag, axis)
    recv_count = counts_mat[:, my]  # 0 at my own row (bypassed)

    recv_k = lax.all_to_all(send_keys, axis, 0, 0, tiled=False)
    recv_v = lax.all_to_all(send_vals, axis, 0, 0, tiled=False)

    # Reassembly: sort by EXPLICIT (key, validity, src chip, src rank) so
    # the bypassed self slice (appended after the received rows, i.e. out
    # of src order) still lands in the stable global position.  Validity
    # must outrank src — a real 0xFFFFFFFF key from a later chip would
    # otherwise tie with an earlier chip's padding and lose its payload to
    # truncation.  Rank proxies need only be monotone within one (key,
    # src) group: chunk-relative iota for received rows (each chunk is a
    # contiguous ascending-rank slice), absolute index for the self slice.
    k_iota = lax.broadcasted_iota(jnp.int32, (P_, capacity), 1)
    invalid_rx = k_iota >= recv_count[:, None]
    src_rx = lax.broadcasted_iota(jnp.int32, (P_, capacity), 0)
    pos = jnp.arange(n, dtype=jnp.int32)
    in_self = (pos >= self_lo) & (pos < self_hi)

    keys_all = jnp.concatenate([
        jnp.where(invalid_rx, PAD_KEY, recv_k).reshape(-1),
        jnp.where(in_self, s, PAD_KEY),
    ])
    invalid_all = jnp.concatenate([
        invalid_rx.reshape(-1).astype(jnp.uint32),
        (~in_self).astype(jnp.uint32),
    ])
    src_all = jnp.concatenate(
        [src_rx.reshape(-1), jnp.broadcast_to(my, (n,)).astype(jnp.int32)]
    )
    rank_all = jnp.concatenate([k_iota.reshape(-1), pos])
    rows_all = jnp.concatenate(
        [recv_v.reshape(P_ * capacity, W), vals_s], axis=0
    )
    if 0 < W <= MAX_SORT_LANES:
        lanes_all = tuple(rows_all[:, w] for w in range(W))
        merged = lax.sort(
            (keys_all, invalid_all, src_all, rank_all, *lanes_all),
            num_keys=4,
        )
        merged_k = merged[0]
        merged_v = jnp.stack(merged[4:], axis=1)
    else:
        flat_idx = jnp.arange(rows_all.shape[0], dtype=jnp.uint32)
        merged_k, _, _, _, perm = lax.sort(
            (keys_all, invalid_all, src_all, rank_all, flat_idx),
            num_keys=4,
        )
        merged_v = jnp.take(rows_all, perm, axis=0)
    total = recv_count.sum().astype(jnp.int32) + (self_hi - self_lo)
    return merged_k, merged_v, total[None], lax.psum(
        overflowed.astype(jnp.int32), axis
    )


def build_sample_sort_kv(
    mesh,
    n_local: int,
    payload_lanes: int,
    *,
    capacity_factor: float = 1.5,
    axis: str = KEY_AXIS,
):
    """Compile-ready distributed stable key-value sample sort.

    ``fn(keys, vals) -> (padded_keys, padded_vals, counts, overflow)`` with
    keys (P*n_local,) and vals (P*n_local, payload_lanes) uint32, both
    sharded over ``axis``.
    """
    nchips = mesh.shape[axis]
    capacity = default_pair_capacity(n_local, nchips, capacity_factor)
    fn = shard_map(
        lambda k, v: _sample_sort_kv_shard(k, v, axis=axis, capacity=capacity),
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P()),
    )
    return jax.jit(fn), capacity


def sort_key_value_distributed(
    keys,
    values,
    *,
    mesh=None,
    capacity_factor: float = 1.5,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-facing distributed stable key-value sort (BASELINE.json config
    3: payload rows follow their keys with deterministic placement).

    ``values``: (n, B) uint8 rows (B a multiple of 4) or any (n, W) uint32
    array.  Returns (sorted_keys, values_in_sorted_order) exactly matching
    a stable single-chip kv sort.
    """
    from .distributed import OverflowError_

    mesh = mesh or key_mesh()
    nchips = mesh.shape[KEY_AXIS]
    keys = np.asarray(keys, dtype=np.uint32)
    values = np.asarray(values)
    n = keys.size
    if values.shape[0] != n:
        raise ValueError(f"values rows {values.shape[0]} != keys {n}")
    vals_u32 = values
    if values.dtype != np.uint32:
        if values.dtype != np.uint8 or values.ndim != 2 or values.shape[1] % 4:
            raise ValueError(
                "values must be (n, W) uint32 or (n, B) uint8 with B % 4 == 0"
            )
        vals_u32 = values.view(np.uint32).reshape(n, -1)
    if vals_u32.ndim != 2:
        raise ValueError(
            "values must be (n, W) uint32 or (n, B) uint8 with B % 4 == 0"
        )
    W = vals_u32.shape[1]

    n_local = max(-(-n // nchips), nchips)
    n_pad = n_local * nchips
    pk = np.full(n_pad, 0xFFFFFFFF, dtype=np.uint32)
    pk[:n] = keys
    pv = np.zeros((n_pad, W), dtype=np.uint32)
    pv[:n] = vals_u32

    sharding = NamedSharding(mesh, P(KEY_AXIS))
    dk = jax.device_put(pk, sharding)
    dv = jax.device_put(pv, sharding)
    fn, capacity = build_sample_sort_kv(
        mesh, n_local, W, capacity_factor=capacity_factor
    )
    mk, mv, counts, overflow = fn(dk, dv)
    if int(overflow) > 0:
        raise OverflowError_(
            "kv sample-sort capacity overflowed; increase capacity_factor"
        )
    mk = np.asarray(jax.device_get(mk)).reshape(nchips, -1)
    mv = np.asarray(jax.device_get(mv)).reshape(nchips, mk.shape[1], W)
    counts = np.asarray(jax.device_get(counts)).reshape(-1)
    out_k = np.concatenate([mk[i, : counts[i]] for i in range(nchips)])
    out_v = np.concatenate([mv[i, : counts[i]] for i in range(nchips)])
    assert out_k.size == n_pad
    out_k, out_v = out_k[:n], out_v[:n]
    if values.dtype != np.uint32:
        out_v = (
            np.ascontiguousarray(out_v.reshape(n, -1))
            .view(np.uint8)
            .reshape(values.shape)
        )
    return out_k, out_v


def _searchsorted_segments(arr, seg_lo, seg_hi, targets, *, side: str):
    """Vectorized binary search of ``targets[i]`` within the sorted
    segment ``arr[seg_lo[i]:seg_hi[i])`` (int32 positions).  The 64-bit
    PSRS uses it to refine a hi-word tie run by the lo word without
    materializing u64 composites (no jax_enable_x64)."""
    n = arr.shape[0]
    lo, hi = seg_lo, seg_hi
    for _ in range(max(n, 2).bit_length()):
        mid = (lo + hi) // 2
        v = arr[jnp.clip(mid, 0, n - 1)]
        go_right = (mid < hi) & (
            (v < targets) if side == "left" else (v <= targets)
        )
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo


def _sample_sort_shard64(hi, lo, *, axis, capacity):
    """Keys-only PSRS over 64-bit keys carried as (hi, lo) uint32 lanes —
    ONE local 2-lane sort + ONE exchange + ONE 2-lane reassembly, vs the
    two full kv stages of the LSD composition.  Same composite-splitter
    scheme as :func:`_sample_sort_shard` with the key extended to
    (hi, lo): candidates are (hi, lo, rank, chip) — distinct, so the
    regular-sampling balance bound holds for any distribution; ties of
    the full 64-bit key round-robin by (rank, chip) exactly like the
    32-bit keys-only path."""
    P_ = lax.axis_size(axis)
    my = lax.axis_index(axis)
    n = hi.shape[0]

    s_hi, s_lo = lax.sort(
        (hi.astype(KEY_DTYPE), lo.astype(KEY_DTYPE)), num_keys=2
    )

    # composite splitters over (hi, lo, rank, chip)
    stride = max(n // P_, 1)
    pos = jnp.arange(P_, dtype=jnp.int32) * stride
    gh = lax.all_gather(s_hi[pos], axis).reshape(-1)
    gl = lax.all_gather(s_lo[pos], axis).reshape(-1)
    cand_r = jnp.tile(pos, P_)
    cand_c = jnp.repeat(jnp.arange(P_, dtype=jnp.int32), P_)
    sh, sl, sr, sc = lax.sort((gh, gl, cand_r, cand_c), num_keys=4)
    idx = jnp.arange(1, P_, dtype=jnp.int32) * P_
    spl_h, spl_l, spl_r, spl_c = sh[idx], sl[idx], sr[idx], sc[idx]

    # local boundary per splitter: #{(hi, lo, rank=my index, chip=my) <
    # (H, L, r_m, c_m)} — hi searchsorted brackets the hi-tie run, the lo
    # word refines WITHIN it (s_lo is sorted inside each hi run), and the
    # full-key tie run [t1, t2) splits by (rank, chip) in closed form
    # (ranks of the tie run ARE its indices).
    c1 = jnp.searchsorted(s_hi, spl_h, side="left").astype(jnp.int32)
    c2 = jnp.searchsorted(s_hi, spl_h, side="right").astype(jnp.int32)
    t1 = _searchsorted_segments(s_lo, c1, c2, spl_l, side="left")
    t2 = _searchsorted_segments(s_lo, c1, c2, spl_l, side="right")
    tie = jnp.clip(spl_r - t1, 0, t2 - t1) + (
        (my < spl_c) & (spl_r >= t1) & (spl_r < t2)
    ).astype(jnp.int32)
    bounds = t1 + tie
    send_bounds = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), bounds, jnp.full(1, n, jnp.int32)]
    )
    send_count = send_bounds[1:] - send_bounds[:-1]
    offdiag, overflowed, self_lo_b, self_hi_b = _self_bypass(
        send_bounds, send_count, my, P_, capacity
    )

    def windows(buf):
        padded = jnp.concatenate(
            [buf, jnp.full((capacity,), PAD_KEY, KEY_DTYPE)]
        )
        return send_windows(padded, send_bounds[:-1], capacity)

    counts_mat = lax.all_gather(offdiag, axis)
    recv_count = counts_mat[:, my]
    recv_h = lax.all_to_all(windows(s_hi), axis, 0, 0, tiled=False)
    recv_l = lax.all_to_all(windows(s_lo), axis, 0, 0, tiled=False)

    k_iota = lax.broadcasted_iota(jnp.int32, (P_, capacity), 1)
    invalid = k_iota >= recv_count[:, None]
    posn = jnp.arange(n, dtype=jnp.int32)
    in_self = (posn >= self_lo_b) & (posn < self_hi_b)
    # pads are (0xFFFFFFFF, 0xFFFFFFFF): they tie only with a real key of
    # IDENTICAL 64-bit value, so the valid prefix is value-exact
    # (keys-only sentinel exception, both words)
    hi_all = jnp.concatenate([
        jnp.where(invalid, PAD_KEY, recv_h).reshape(-1),
        jnp.where(in_self, s_hi, PAD_KEY),
    ])
    lo_all = jnp.concatenate([
        jnp.where(invalid, PAD_KEY, recv_l).reshape(-1),
        jnp.where(in_self, s_lo, PAD_KEY),
    ])
    m_hi, m_lo = lax.sort((hi_all, lo_all), num_keys=2)
    total = recv_count.sum().astype(jnp.int32) + (self_hi_b - self_lo_b)
    return m_hi, m_lo, total[None], lax.psum(
        overflowed.astype(jnp.int32), axis
    )


def build_sample_sort_64(
    mesh,
    n_local: int,
    *,
    capacity_factor: float = 1.5,
    axis: str = KEY_AXIS,
):
    """Compile-ready single-pass distributed 64-bit sample sort.

    ``fn(hi, lo) -> (m_hi, m_lo, counts, overflow)`` with hi/lo the
    (P*n_local,) uint32 word lanes of the encoded u64 keys, sharded over
    ``axis``."""
    nchips = mesh.shape[axis]
    capacity = default_pair_capacity(n_local, nchips, capacity_factor)
    fn = shard_map(
        lambda h, l: _sample_sort_shard64(h, l, axis=axis, capacity=capacity),
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P()),
    )
    return jax.jit(fn), capacity


def _sample_sort_kv_shard64(hi, lo, local_vals, *, axis, capacity):
    """Stable kv PSRS with 64-bit keys carried as (hi, lo) uint32 lanes —
    the kv twin of :func:`_sample_sort_shard64` and the 64-bit twin of
    :func:`_sample_sort_kv_shard`.  Stability: ties of the full (hi, lo)
    key break by (source chip, original local index) = global input order,
    matching a stable single-chip kv sort of the linearized input."""
    P_ = lax.axis_size(axis)
    my = lax.axis_index(axis)
    n = hi.shape[0]
    W = local_vals.shape[1]

    if 0 < W <= MAX_SORT_LANES:
        lanes = tuple(local_vals[:, w] for w in range(W))
        sorted_ops = lax.sort(
            (hi.astype(KEY_DTYPE), lo.astype(KEY_DTYPE), *lanes),
            num_keys=2, is_stable=True,
        )
        s_hi, s_lo = sorted_ops[0], sorted_ops[1]
        vals_s = jnp.stack(sorted_ops[2:], axis=1)
    else:
        idx = jnp.arange(n, dtype=jnp.uint32)
        s_hi, s_lo, order = lax.sort(
            (hi.astype(KEY_DTYPE), lo.astype(KEY_DTYPE), idx),
            num_keys=2, is_stable=True,
        )
        vals_s = jnp.take(local_vals, order, axis=0)

    # composite splitters over (hi, lo, chip, rank) — the STABLE tie order
    # (cf. _composite_splitters order="chip_rank")
    stride = max(n // P_, 1)
    pos = jnp.arange(P_, dtype=jnp.int32) * stride
    gh = lax.all_gather(s_hi[pos], axis).reshape(-1)
    gl = lax.all_gather(s_lo[pos], axis).reshape(-1)
    cand_r = jnp.tile(pos, P_)
    cand_c = jnp.repeat(jnp.arange(P_, dtype=jnp.int32), P_)
    sh, sl, sc, sr = lax.sort((gh, gl, cand_c, cand_r), num_keys=4)
    idx_q = jnp.arange(1, P_, dtype=jnp.int32) * P_
    spl_h, spl_l, spl_c, spl_r = sh[idx_q], sl[idx_q], sc[idx_q], sr[idx_q]

    # local boundary: #{(hi, lo, chip=my, rank=idx) < (H, L, c_m, r_m)} —
    # the (hi, lo) tie run [t1, t2) splits by (chip, rank): earlier chips
    # contribute the whole run, the splitter's own chip its rank prefix.
    c1 = jnp.searchsorted(s_hi, spl_h, side="left").astype(jnp.int32)
    c2 = jnp.searchsorted(s_hi, spl_h, side="right").astype(jnp.int32)
    t1 = _searchsorted_segments(s_lo, c1, c2, spl_l, side="left")
    t2 = _searchsorted_segments(s_lo, c1, c2, spl_l, side="right")
    tie = jnp.where(
        my < spl_c,
        t2 - t1,
        jnp.where(my == spl_c, jnp.clip(spl_r - t1, 0, t2 - t1), 0),
    )
    bounds = t1 + tie
    send_bounds = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), bounds, jnp.full(1, n, jnp.int32)]
    )
    send_count = send_bounds[1:] - send_bounds[:-1]
    offdiag, overflowed, self_lo_b, self_hi_b = _self_bypass(
        send_bounds, send_count, my, P_, capacity
    )

    padded_h = jnp.concatenate([s_hi, jnp.full((capacity,), PAD_KEY, KEY_DTYPE)])
    padded_l = jnp.concatenate([s_lo, jnp.full((capacity,), PAD_KEY, KEY_DTYPE)])
    padded_v = jnp.concatenate(
        [vals_s, jnp.zeros((capacity, W), jnp.uint32)], axis=0
    )
    counts_mat = lax.all_gather(offdiag, axis)
    recv_count = counts_mat[:, my]
    recv_h = lax.all_to_all(
        send_windows(padded_h, send_bounds[:-1], capacity), axis, 0, 0,
        tiled=False,
    )
    recv_l = lax.all_to_all(
        send_windows(padded_l, send_bounds[:-1], capacity), axis, 0, 0,
        tiled=False,
    )
    recv_v = lax.all_to_all(
        send_windows(padded_v, send_bounds[:-1], capacity), axis, 0, 0,
        tiled=False,
    )

    # Reassembly: explicit (hi, lo, validity, src chip, src rank) — same
    # scheme as the 32-bit kv path (validity outranks src so a real
    # (0xFFFFFFFF, 0xFFFFFFFF) key never loses its payload to a pad).
    k_iota = lax.broadcasted_iota(jnp.int32, (P_, capacity), 1)
    invalid_rx = k_iota >= recv_count[:, None]
    src_rx = lax.broadcasted_iota(jnp.int32, (P_, capacity), 0)
    posn = jnp.arange(n, dtype=jnp.int32)
    in_self = (posn >= self_lo_b) & (posn < self_hi_b)

    hi_all = jnp.concatenate([
        jnp.where(invalid_rx, PAD_KEY, recv_h).reshape(-1),
        jnp.where(in_self, s_hi, PAD_KEY),
    ])
    lo_all = jnp.concatenate([
        jnp.where(invalid_rx, PAD_KEY, recv_l).reshape(-1),
        jnp.where(in_self, s_lo, PAD_KEY),
    ])
    invalid_all = jnp.concatenate([
        invalid_rx.reshape(-1).astype(jnp.uint32),
        (~in_self).astype(jnp.uint32),
    ])
    src_all = jnp.concatenate(
        [src_rx.reshape(-1), jnp.broadcast_to(my, (n,)).astype(jnp.int32)]
    )
    rank_all = jnp.concatenate([k_iota.reshape(-1), posn])
    rows_all = jnp.concatenate(
        [recv_v.reshape(P_ * capacity, W), vals_s], axis=0
    )
    if 0 < W <= MAX_SORT_LANES:
        lanes_all = tuple(rows_all[:, w] for w in range(W))
        merged = lax.sort(
            (hi_all, lo_all, invalid_all, src_all, rank_all, *lanes_all),
            num_keys=5,
        )
        m_hi, m_lo = merged[0], merged[1]
        merged_v = jnp.stack(merged[5:], axis=1)
    else:
        flat_idx = jnp.arange(rows_all.shape[0], dtype=jnp.uint32)
        m_hi, m_lo, _, _, _, perm = lax.sort(
            (hi_all, lo_all, invalid_all, src_all, rank_all, flat_idx),
            num_keys=5,
        )
        merged_v = jnp.take(rows_all, perm, axis=0)
    total = recv_count.sum().astype(jnp.int32) + (self_hi_b - self_lo_b)
    return m_hi, m_lo, merged_v, total[None], lax.psum(
        overflowed.astype(jnp.int32), axis
    )


def build_sample_sort_kv64(
    mesh,
    n_local: int,
    payload_lanes: int,
    *,
    capacity_factor: float = 1.5,
    axis: str = KEY_AXIS,
):
    """Compile-ready distributed stable kv sample sort with 64-bit keys.

    ``fn(hi, lo, vals) -> (m_hi, m_lo, m_vals, counts, overflow)`` with
    hi/lo the (P*n_local,) uint32 word lanes of the encoded u64 keys and
    vals (P*n_local, payload_lanes) uint32, all sharded over ``axis``."""
    nchips = mesh.shape[axis]
    capacity = default_pair_capacity(n_local, nchips, capacity_factor)
    fn = shard_map(
        lambda h, l, v: _sample_sort_kv_shard64(
            h, l, v, axis=axis, capacity=capacity
        ),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P()),
    )
    return jax.jit(fn), capacity


def sort_key_value_distributed_64(
    keys,
    values,
    *,
    mesh=None,
    capacity_factor: float = 1.5,
    single_pass: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-facing distributed stable key-value sort with 64-BIT keys
    (uint64 / int64 / float64 totalOrder) — the kv twin of
    :func:`sort_distributed_64`, completing the north-star 64-bit surface
    beyond the reference's uint32-only C ABI (libsort/libsort.h:19).

    ``values`` as in :func:`sort_key_value_distributed` ((n, B) uint8 rows
    with B % 4 == 0, or any (n, W) uint32 array).  Default: ONE stable kv
    PSRS over the (hi, lo) word lanes; ``single_pass=False`` (and the
    overflow fallback) composes TWO stable 32-bit kv PSRS stages (by lo
    carrying hi+payload, then by hi carrying lo+payload) — the independent
    cross-check, ~2x the work.
    """
    from ..ops.bits import decode_ordered_np64, encode_ordered_np64
    from .distributed import OverflowError_

    keys = np.asarray(keys)
    if keys.dtype not in (np.uint64, np.int64, np.float64):
        raise TypeError(
            f"sort_key_value_distributed_64 takes uint64/int64/float64 "
            f"keys, got {keys.dtype}"
        )
    values = np.asarray(values)
    n = keys.size
    if values.shape[0] != n:
        raise ValueError(f"values rows {values.shape[0]} != keys {n}")
    vals_u32 = values
    if values.dtype != np.uint32:
        if values.dtype != np.uint8 or values.ndim != 2 or values.shape[1] % 4:
            raise ValueError(
                "values must be (n, W) uint32 or (n, B) uint8 with B % 4 == 0"
            )
        vals_u32 = values.view(np.uint32).reshape(n, -1)
    if vals_u32.ndim != 2:
        raise ValueError(
            "values must be (n, W) uint32 or (n, B) uint8 with B % 4 == 0"
        )
    W = vals_u32.shape[1]

    enc = encode_ordered_np64(keys)
    lo = (enc & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (enc >> np.uint64(32)).astype(np.uint32)

    def _restore(out_hi, out_lo, out_v):
        out64 = (out_hi.astype(np.uint64) << np.uint64(32)) | out_lo.astype(
            np.uint64
        )
        out_k = decode_ordered_np64(out64, keys.dtype)
        if values.dtype != np.uint32:
            out_v = (
                np.ascontiguousarray(out_v.reshape(n, -1))
                .view(np.uint8)
                .reshape(values.shape)
            )
        return out_k, out_v

    if single_pass:
        mesh_ = mesh or key_mesh()
        nchips = mesh_.shape[KEY_AXIS]
        n_local = max(-(-n // nchips), nchips)
        n_pad = n_local * nchips
        ph = np.full(n_pad, 0xFFFFFFFF, dtype=np.uint32)
        pl_ = np.full(n_pad, 0xFFFFFFFF, dtype=np.uint32)
        ph[:n], pl_[:n] = hi, lo
        pv = np.zeros((n_pad, W), dtype=np.uint32)
        pv[:n] = vals_u32
        sharding = NamedSharding(mesh_, P(KEY_AXIS))
        fn, _cap = build_sample_sort_kv64(
            mesh_, n_local, W, capacity_factor=capacity_factor
        )
        mh, ml, mv, counts, overflow = fn(
            jax.device_put(ph, sharding),
            jax.device_put(pl_, sharding),
            jax.device_put(pv, sharding),
        )
        if int(overflow) == 0:
            mh = np.asarray(jax.device_get(mh)).reshape(nchips, -1)
            ml = np.asarray(jax.device_get(ml)).reshape(nchips, -1)
            mv = np.asarray(jax.device_get(mv)).reshape(
                nchips, mh.shape[1], W
            )
            counts = np.asarray(jax.device_get(counts)).reshape(-1)
            oh = np.concatenate([mh[i, : counts[i]] for i in range(nchips)])
            ol = np.concatenate([ml[i, : counts[i]] for i in range(nchips)])
            ov = np.concatenate([mv[i, : counts[i]] for i in range(nchips)])
            assert oh.size == n_pad
            return _restore(oh[:n], ol[:n], ov[:n])
        # adversarial cross-chip placement overflowed: LSD composition

    # pass 1: stable by lo carrying (hi, payload); pass 2: stable by hi
    # carrying (lo, payload) — stability makes the composition exact.
    v1 = np.concatenate([hi[:, None], vals_u32], axis=1)
    slo, sv1 = sort_key_value_distributed(
        lo, v1, mesh=mesh, capacity_factor=capacity_factor
    )
    v2 = np.concatenate([slo[:, None], sv1[:, 1:]], axis=1)
    shi2, sv2 = sort_key_value_distributed(
        sv1[:, 0], v2, mesh=mesh, capacity_factor=capacity_factor
    )
    return _restore(shi2, sv2[:, 0], sv2[:, 1:])


def sort_distributed_64(
    keys,
    *,
    mesh=None,
    capacity_factor: float = 1.5,
    single_pass: bool = True,
) -> np.ndarray:
    """Host-facing distributed full sort of 64-bit keys (uint64 / int64 /
    float64, the float64 order being IEEE-754 totalOrder) — beyond the
    reference's uint32-only C ABI (libsort/libsort.h:19), and the
    distributed twin of :func:`ops.radix_sort.sort_full_u64`.

    Default (``single_pass=True``): ONE keys-only PSRS over the (hi, lo)
    word lanes (:func:`_sample_sort_shard64`) — one local 2-lane sort,
    one exchange, one reassembly.  ``single_pass=False`` (and the
    overflow fallback) runs the LSD composition instead: TWO distributed
    stable kv sample sorts (stable by lo carrying hi, then stable by hi
    carrying lo) on the proven :func:`sort_key_value_distributed`
    machinery — ~2x the work, kept as the independent cross-check.  No
    jax_enable_x64 required — 64-bit words exist only host-side.
    """
    from .distributed import OverflowError_

    keys = np.asarray(keys)
    if keys.dtype not in (np.uint64, np.int64, np.float64):
        raise TypeError(
            f"sort_distributed_64 takes uint64/int64/float64 keys, got "
            f"{keys.dtype}"
        )
    from ..ops.bits import decode_ordered_np64, encode_ordered_np64

    enc = encode_ordered_np64(keys)
    lo = (enc & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (enc >> np.uint64(32)).astype(np.uint32)

    if single_pass:
        mesh = mesh or key_mesh()
        nchips = mesh.shape[KEY_AXIS]
        n = keys.size
        n_local = max(-(-n // nchips), nchips)
        n_pad = n_local * nchips
        ph = np.full(n_pad, 0xFFFFFFFF, dtype=np.uint32)
        pl_ = np.full(n_pad, 0xFFFFFFFF, dtype=np.uint32)
        ph[:n], pl_[:n] = hi, lo
        sharding = NamedSharding(mesh, P(KEY_AXIS))
        fn, _cap = build_sample_sort_64(
            mesh, n_local, capacity_factor=capacity_factor
        )
        mh, ml, counts, overflow = fn(
            jax.device_put(ph, sharding), jax.device_put(pl_, sharding)
        )
        if int(overflow) == 0:
            mh = np.asarray(jax.device_get(mh)).reshape(nchips, -1)
            ml = np.asarray(jax.device_get(ml)).reshape(nchips, -1)
            counts = np.asarray(jax.device_get(counts)).reshape(-1)
            oh = np.concatenate([mh[i, : counts[i]] for i in range(nchips)])
            ol = np.concatenate([ml[i, : counts[i]] for i in range(nchips)])
            assert oh.size == n_pad
            out = (oh[:n].astype(np.uint64) << np.uint64(32)) | ol[:n].astype(
                np.uint64
            )
            return decode_ordered_np64(out, keys.dtype)
        # adversarial cross-chip placement overflowed the pair capacity:
        # fall through to the two-stage LSD composition

    # pass 1: stable by lo, carry hi; pass 2: stable by hi, carry lo.
    slo, shi = sort_key_value_distributed(
        lo, hi[:, None], mesh=mesh, capacity_factor=capacity_factor
    )
    shi2, slo2 = sort_key_value_distributed(
        shi.reshape(-1), slo[:, None], mesh=mesh,
        capacity_factor=capacity_factor,
    )
    out = (shi2.astype(np.uint64) << np.uint64(32)) | slo2.reshape(-1).astype(
        np.uint64
    )
    return decode_ordered_np64(out, keys.dtype)


def sort_distributed_sample(
    keys,
    *,
    mesh=None,
    capacity_factor: float = 1.5,
    fallback: bool = True,
    reassembly: str = "sort",
) -> np.ndarray:
    """Host-facing distributed sample sort: pads, shards, runs PSRS,
    linearizes the ragged sorted shards exactly.

    Composite splitters + the diagonal bypass make duplicates (all-equal,
    Zipf) and self-destined (already-sorted) inputs first-class on this
    path.  Overflow now requires adversarial cross-chip placement — one
    chip holding > capacity keys destined to one OTHER chip (e.g. globally
    reverse-block-sorted input); with ``fallback=True`` such overflows
    retry through the exact gather exchange, otherwise they raise
    ``OverflowError_``.
    """
    from .distributed import OverflowError_

    keys = np.asarray(keys)
    if keys.dtype in (np.int32, np.float32):
        # order-preserving u32 bijection (ops/bits.py), encoded host-side
        from ..ops.bits import decode_ordered_np, encode_ordered_np

        out = sort_distributed_sample(
            encode_ordered_np(keys), mesh=mesh,
            capacity_factor=capacity_factor, fallback=fallback,
            reassembly=reassembly,
        )
        return decode_ordered_np(out, keys.dtype)
    mesh = mesh or key_mesh()
    nchips = mesh.shape[KEY_AXIS]
    keys = np.asarray(keys, dtype=np.uint32)
    n = keys.size
    n_local = max(-(-n // nchips), nchips)  # >= P for regular sampling
    n_pad = n_local * nchips
    padded = np.full(n_pad, 0xFFFFFFFF, dtype=np.uint32)
    padded[:n] = keys

    dev = jax.device_put(padded, NamedSharding(mesh, P(KEY_AXIS)))
    fn, capacity = build_sample_sort(
        mesh, n_local, capacity_factor=capacity_factor,
        reassembly=reassembly,
    )
    shards, counts, overflow = fn(dev)
    if int(overflow) > 0:
        if fallback:
            from .distributed import sort_distributed

            return sort_distributed(keys, mesh=mesh, exchange="gather")
        raise OverflowError_(
            "sample-sort pair capacity overflowed; increase capacity_factor "
            "or use the gather exchange for duplicate-heavy data"
        )
    shards = np.asarray(jax.device_get(shards)).reshape(nchips, -1)
    counts = np.asarray(jax.device_get(counts)).reshape(-1)
    out = np.concatenate([shards[i, : counts[i]] for i in range(nchips)])
    assert out.size == n_pad, (out.size, n_pad)
    return out[:n]
