"""Device→host transfer of a device array's valid prefix, in chunks.

Chunks keep uniform (compile-cached) shapes, so a pow2-padded array's pad
tail need not cross to the host, and the chunks are fetched on a few
threads.  Whether the threads pay off on a PCIe-attached GPU is not
measured yet.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

_CHUNK_BYTES = 32 << 20
_MAX_STREAMS = 8


def chunked_device_get(x, *, limit: int | None = None,
                       chunk_bytes: int = _CHUNK_BYTES,
                       max_streams: int = _MAX_STREAMS) -> np.ndarray:
    """Fetch a 1-D device array to host as parallel chunk streams.

    ``limit`` fetches only the first ``limit`` elements — chunks keep
    their uniform (compile-cached) shapes and at most one trailing chunk
    of excess crosses the wire, so pow2-padded workers don't pay up to 2x
    D2H for the pad tail.

    Falls back to a plain copy for host arrays and small transfers.
    Device-side slicing materializes chunk buffers (briefly twice the
    array's device memory).
    """
    import jax

    if not hasattr(x, "addressable_shards"):  # plain numpy already
        return np.asarray(x) if limit is None else np.asarray(x)[:limit]
    n = x.shape[0] if limit is None else min(limit, x.shape[0])
    rows_per = max(chunk_bytes // max(x.dtype.itemsize, 1), 1)
    if x.ndim != 1 or x.shape[0] <= rows_per:
        return np.asarray(x)[:n]
    slices = [x[i : i + rows_per] for i in range(0, n, rows_per)]
    jax.block_until_ready(slices)
    out = np.empty(n, dtype=x.dtype)
    starts = range(0, n, rows_per)
    with ThreadPoolExecutor(min(max_streams, len(slices))) as pool:
        for i, chunk in zip(starts, pool.map(np.asarray, slices)):
            m = min(chunk.shape[0], n - i)  # trailing chunk may pass limit
            out[i : i + m] = chunk[:m]
    return out
