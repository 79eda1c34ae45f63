"""Digit/bit-field helpers shared by all sort strategies.

Reference analog: the ``group_bits`` macro (libsort/sort.cu:9) and the 2-bit
extraction inside the kernels (sort.cu:84).  Canonical unit everywhere in
this framework is *elements* (uint32 keys); byte offsets exist only inside
the storage layer (see data/interface.py), resolving the reference's mixed
element/byte conventions (libsort.h:19 vs benchmark/pkg/sort/libsort.go:58).
"""

from __future__ import annotations

import jax.numpy as jnp

KEY_DTYPE = jnp.uint32
KEY_BITS = 32


def validate_digit_range(offset: int, width: int) -> None:
    if not (0 < width <= KEY_BITS and 0 <= offset and offset + width <= KEY_BITS):
        raise ValueError(
            f"digit range [offset={offset}, offset+width={offset + width}) "
            f"must lie within [0, {KEY_BITS}) with width >= 1"
        )


def digit_mask(width: int) -> int:
    return 0xFFFFFFFF if width == KEY_BITS else (1 << width) - 1


def extract_digits(keys: jnp.ndarray, offset: int, width: int) -> jnp.ndarray:
    """bits [offset, offset+width) of each key, as uint32."""
    validate_digit_range(offset, width)
    keys = keys.astype(KEY_DTYPE)
    return (keys >> KEY_DTYPE(offset)) & KEY_DTYPE(digit_mask(width))


def rotr32(x: jnp.ndarray, s: int) -> jnp.ndarray:
    """Static cyclic right-rotation of uint32 bit patterns (s mod 32).

    The rotated-value LSD trick's workhorse: round k's
    required order (digit_k, bits [0, k*w), high bits) is the plain
    ascending order of rotr(x, (k+1)*w) — a pure value function, so the
    round sort is keys-only.  Shared by the mesh loop
    (parallel/distributed._fused_sort_shard) and the storage plane's fused
    device rounds (parallel/storage_sort._fused_round_jit)."""
    s %= 32
    if s == 0:
        return x
    return (x >> jnp.uint32(s)) | (x << jnp.uint32(32 - s))


def rotr64_lanes(
    hi: jnp.ndarray, lo: jnp.ndarray, s: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Static cyclic right-rotation of 64-bit values held as (hi, lo)
    uint32 word lanes — the 64-bit twin of :func:`rotr32`, keeping the
    rotated-value LSD trick x64-free on device (no uint64 anywhere).
    Returns (hi', lo') of rotr64((hi << 32) | lo, s)."""
    s %= 64
    if s == 0:
        return hi, lo
    if s == 32:
        return lo, hi
    if s > 32:
        hi, lo = lo, hi
        s -= 32
    # 0 < s < 32: each word keeps its top bits shifted down and receives
    # the OTHER word's low s bits at the top.
    sh, inv = jnp.uint32(s), jnp.uint32(32 - s)
    new_lo = (lo >> sh) | (hi << inv)
    new_hi = (hi >> sh) | (lo << inv)
    return new_hi, new_lo


def _ordered_codec(xp, a, dtype, bits: int, decode: bool):
    """Shared body of the encode/decode_ordered* variants: identity for
    unsigned, sign-bit flip for two's-complement ints, IEEE-754 totalOrder
    mask for floats (negatives fully complemented so their order reverses
    and they land below positives; -0.0 < +0.0; positive NaNs above +inf,
    negative NaNs below -inf).  ``xp`` is the array module (jnp or np);
    ``bits`` selects the 32- or 64-bit family."""
    utype = getattr(xp, f"uint{bits}")
    itype = getattr(xp, f"int{bits}")
    ftype = getattr(xp, f"float{bits}")
    dtype = xp.dtype(dtype)
    sign = utype(1 << (bits - 1))
    ones = utype((1 << bits) - 1)
    if dtype == utype:
        return a
    if dtype == itype:
        return (a ^ sign).view(itype) if decode else a.view(utype) ^ sign
    if dtype == ftype:
        if decode:
            mask = xp.where((a >> utype(bits - 1)) != 0, sign, ones)
            return (a ^ mask).view(ftype)
        u = a.view(utype)
        mask = xp.where((u >> utype(bits - 1)) != 0, ones, sign)
        return u ^ mask
    raise TypeError(
        f"unsupported key dtype {dtype}; use uint{bits}/int{bits}/float{bits}"
    )


def encode_ordered(x: jnp.ndarray) -> jnp.ndarray:
    """Order-preserving bijection from int32 / float32 / uint32 keys onto
    uint32, so every u32 sort engine in this package serves typed keys.

    * uint32: identity.
    * int32:  flip the sign bit (two's complement order -> unsigned order).
    * float32: IEEE-754 totalOrder (the radix-sort classic) — a TOTAL
      order refining the usual float comparison (np.sort instead moves
      every NaN last); see _ordered_codec for the exact placement rules.

    Beyond the reference (uint32-only keys, libsort.h:19); standard radix
    technique, exposed so sort_full/sort_key_value accept typed keys.
    """
    return _ordered_codec(jnp, x, x.dtype, 32, decode=False)


def decode_ordered(u: jnp.ndarray, dtype) -> jnp.ndarray:
    """Inverse of :func:`encode_ordered` for the given original dtype."""
    return _ordered_codec(jnp, u, dtype, 32, decode=True)


def encode_ordered_np(x):
    """numpy twin of :func:`encode_ordered` for host-side wrappers (the
    distributed entry points encode before padding/sharding so
    out-of-core-scale arrays never round-trip through the device)."""
    import numpy as np

    return _ordered_codec(np, x, x.dtype, 32, decode=False)


def decode_ordered_np(u, dtype):
    """numpy inverse of :func:`encode_ordered_np`."""
    import numpy as np

    return _ordered_codec(np, u, dtype, 32, decode=True)


def encode_ordered_np64(x):
    """Order-preserving bijection from uint64 / int64 / float64 keys onto
    uint64 (numpy, host-side) — the 64-bit twin of
    :func:`encode_ordered_np`; float64 gets IEEE-754 totalOrder."""
    import numpy as np

    return _ordered_codec(np, x, x.dtype, 64, decode=False)


def decode_ordered_np64(u, dtype):
    """numpy inverse of :func:`encode_ordered_np64`."""
    import numpy as np

    return _ordered_codec(np, u, dtype, 64, decode=True)
