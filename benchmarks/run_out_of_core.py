"""Out-of-core storage-plane sort runner (BASELINE configs 1 & 3).

Runs the multi-round storage-mediated distributed sort at scales that
exceed device HBM, through the file backend (the reference's 512Mi-key
workload, benchmark/pkg/benchmark/benchmark.go:126-180, scaled up):

  keys-only:  python benchmarks/run_out_of_core.py --rows 1073741824
  config 3:   python benchmarks/run_out_of_core.py --rows 268435456 \
                  --payload-bytes 64

Exactness proof without holding a (rows x payload) oracle in RAM:
  * keys: the full sorted key stream is compared chunk-by-chunk against
    np.sort of the (re-generated) input keys — exact.
  * payload binding: payload bytes are a pure function of (key, original
    row index); every output row is checked against f(key, idx).
  * stability + permutation: within an equal-key run original indices must
    STRICTLY increase — with the exact key match and the binding this also
    proves no row was duplicated or dropped (a repeat inside a run breaks
    strict increase; a cross-key swap breaks the key stream or binding).

Prints one JSON line on stdout; diagnostics on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from gpu_radix_sort_tpu.data import FileArrayFactory, create_shape  # noqa: E402
from gpu_radix_sort_tpu.parallel import (  # noqa: E402
    BucketReader,
    ReadOrder,
    local_distrib_worker,
    make_kv_worker,
    sort_distrib_from_arr,
)
from gpu_radix_sort_tpu.utils.keygen import Pcg32  # noqa: E402
from gpu_radix_sort_tpu.utils.timers import SortStats  # noqa: E402

KEY_XOR = np.uint32(0xA5A5A5A5)
CHUNK_ROWS = 1 << 22  # 4M rows per staging/verify chunk


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def payload_for(keys: np.ndarray, idx0: int, payload_bytes: int,
                out: np.ndarray | None = None) -> np.ndarray:
    """Deterministic payload rows for keys[i] at original index idx0+i:
    [key ^ KEY_XOR (4B LE)] [index (8B LE, or 4B LE when payload < 12B)]
    [filler = (index + j) & 0xFF].  The index field is what lets the
    verifier prove stability and row conservation without an oracle of
    the full payload; 8-byte payloads carry it as u32 (valid to 2^32-1
    rows)."""
    n = keys.size
    if out is None:
        out = np.empty((n, payload_bytes), dtype=np.uint8)
    out[:, :4] = (keys ^ KEY_XOR).view(np.uint8).reshape(n, 4)
    idx = np.arange(idx0, idx0 + n, dtype=np.uint64)
    # (idx + j) & 0xFF == u8 wraparound of (idx & 0xFF) + (j & 0xFF):
    # staying in uint8 avoids an (n, payload) uint64 temporary (~8x the
    # memory traffic — it page-fault-thrashed at 17 GiB scale).
    idx8 = (idx & np.uint64(0xFF)).astype(np.uint8)
    if payload_bytes >= 12:
        out[:, 4:12] = idx.view(np.uint8).reshape(n, 8)
        j8 = np.arange(12, payload_bytes, dtype=np.uint64).astype(np.uint8)
        np.add(idx8[:, None], j8[None, :], out=out[:, 12:])
    elif payload_bytes >= 8:
        out[:, 4:8] = idx.astype(np.uint32).view(np.uint8).reshape(n, 4)
        j8 = np.arange(8, payload_bytes, dtype=np.uint64).astype(np.uint8)
        np.add(idx8[:, None], j8[None, :], out=out[:, 8:])
    else:
        raise ValueError("payload_bytes must be >= 8 (binding + index)")
    return out


def main():
    from gpu_radix_sort_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 30)
    ap.add_argument("--payload-bytes", type=int, default=0)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--nworker", type=int, default=1)
    ap.add_argument("--mount", default=os.path.join(REPO, "ooc_mount"))
    ap.add_argument("--name", default="ooc")
    ap.add_argument(
        "--parallel-workers", action="store_true",
        help="let workers run concurrently (default: serialize — one chip "
        "owns the device work and concurrent shards would double peak HBM)",
    )
    ap.add_argument(
        "--stage-only", action="store_true",
        help="write the input array and exit (host-only; lets staging run "
        "while another process owns the chip)",
    )
    ap.add_argument(
        "--skip-staging", action="store_true",
        help="reuse an input array staged earlier by --stage-only "
        "(the key oracle is regenerated — the PCG32 stream is deterministic)",
    )
    args = ap.parse_args()

    n = args.rows
    pb = args.payload_bytes
    if 8 <= pb < 12 and n > (1 << 32):
        # the 8-11B payload carries the original index as u32; beyond
        # 2^32 rows it wraps and the stability/conservation proof breaks
        # (a correct sort would be reported as a FATAL stability
        # violation).  12B+ payloads carry a u64 index.
        ap.error("--payload-bytes < 12 limits --rows to 2^32 (u32 index)")
    if pb != 0 and pb < 8:
        # The streaming exactness proof needs the key-xor binding (4B) AND
        # the original-index field (>=4B): without the index, stability and
        # row conservation cannot be proven and "exact" would overclaim.
        ap.error("--payload-bytes must be 0 (keys-only) or >= 8")
    row_bytes = 4 + pb
    factory = FileArrayFactory(args.mount)
    stats = SortStats()
    t_start = time.time()

    log(f"rows={n:,} payload={pb}B row={row_bytes}B width={args.width} "
        f"nworker={args.nworker} total={n * row_bytes / 2**30:.1f} GiB")

    # ---- stage input in chunks (no full-row materialization) -------------
    t0 = time.time()
    gen = Pcg32()
    if args.skip_staging:
        arr_in = factory.open(f"{args.name}.input")
        got = sum(arr_in.get_shape().lens)
        if got != n * row_bytes:
            log(f"FATAL: staged input holds {got} bytes, want {n * row_bytes}")
            sys.exit(2)
        log("reused staged input")
    else:
        arr_in = factory.create(
            f"{args.name}.input", create_shape([n * row_bytes])
        )
        w = arr_in.get_part_writer(0)
        for c0 in range(0, n, CHUNK_ROWS):
            c1 = min(c0 + CHUNK_ROWS, n)
            keys = gen.fill(c1 - c0)
            if pb:
                rows = np.empty((c1 - c0, row_bytes), dtype=np.uint8)
                rows[:, :4] = keys.view(np.uint8).reshape(-1, 4)
                payload_for(keys, c0, pb, out=rows[:, 4:])
                w.write(memoryview(rows.reshape(-1)))
            else:
                w.write(memoryview(keys.view(np.uint8)))
        arr_in.close()
        log(f"staged input in {time.time() - t0:.1f}s")
        if args.stage_only:
            log("stage-only: done")
            sys.exit(0)

    # ---- sort -------------------------------------------------------------
    worker = make_kv_worker(row_bytes) if pb else local_distrib_worker
    if not args.parallel_workers:
        import threading

        lock = threading.Lock()
        inner = worker

        def worker(refs, offset, width, out_name, fac):
            with lock:
                return inner(refs, offset, width, out_name, fac)

    t0 = time.time()
    outputs = sort_distrib_from_arr(
        [arr_in],
        args.name,
        factory,
        worker,
        width=args.width,
        nworker=args.nworker,
        stats=stats,
        row_bytes=row_bytes,
    )
    sort_s = time.time() - t0
    log(f"sorted in {sort_s:.1f}s  phases={stats.report()}")

    # ---- verify (streaming) ------------------------------------------------
    # The oracle is REGENERATED here (deterministic PCG32 stream) rather
    # than held through the sort: peak host RSS during the rounds drops by
    # rows*4 bytes (16 GB at the 4B-row config).
    t0 = time.time()
    all_keys = np.empty(n, dtype=np.uint32)
    oracle_gen = Pcg32()
    for c0 in range(0, n, CHUNK_ROWS):
        c1 = min(c0 + CHUNK_ROWS, n)
        all_keys[c0:c1] = oracle_gen.fill(c1 - c0)
    want_keys = np.sort(all_keys)
    del all_keys
    reader = BucketReader(outputs, ReadOrder.STRIDED)
    pos = 0
    prev_key = -1
    prev_idx = -1
    ok = True
    while True:
        raw = reader.read(CHUNK_ROWS * row_bytes)
        if not raw:
            break
        rows = np.frombuffer(raw, dtype=np.uint8).reshape(-1, row_bytes)
        m = rows.shape[0]
        keys = np.ascontiguousarray(rows[:, :4]).view(np.uint32).reshape(-1)
        if not np.array_equal(keys, want_keys[pos : pos + m]):
            ok = False
            log(f"FATAL: key mismatch in chunk at row {pos}")
            break
        if pb >= 8:
            pay = np.ascontiguousarray(rows[:, 4:])
            kx = np.ascontiguousarray(pay[:, :4]).view(np.uint32).reshape(-1)
            if not np.array_equal(kx, keys ^ KEY_XOR):
                ok = False
                log(f"FATAL: payload/key binding broken at row {pos}")
                break
            if pb >= 12:
                idx = np.ascontiguousarray(pay[:, 4:12]).view(
                    np.uint64
                ).reshape(-1)
                fill0 = 12
            else:
                idx = np.ascontiguousarray(pay[:, 4:8]).view(
                    np.uint32
                ).reshape(-1).astype(np.uint64)
                fill0 = 8
            if int(idx.max(initial=0)) >= n:
                ok = False
                log("FATAL: out-of-range original index")
                break
            if pb > fill0:
                j8 = np.arange(fill0, pb, dtype=np.uint64).astype(np.uint8)
                want_fill = (idx & np.uint64(0xFF)).astype(np.uint8)[
                    :, None
                ] + j8[None, :]
                if not np.array_equal(pay[:, fill0:], want_fill):
                    ok = False
                    log(f"FATAL: payload filler mismatch at row {pos}")
                    break
            # stability: indices increase within equal-key runs (include
            # the boundary with the previous chunk)
            kk = np.concatenate([[np.uint32(prev_key & 0xFFFFFFFF)], keys]) \
                if prev_key >= 0 else keys
            ii = np.concatenate([[np.uint64(prev_idx)], idx]) \
                if prev_key >= 0 else idx
            same = kk[1:] == kk[:-1]
            if np.any(same & ~(ii[1:] > ii[:-1])):
                ok = False
                log(f"FATAL: stability violated near row {pos}")
                break
            prev_idx = int(idx[-1])
            prev_key = int(keys[-1])
        pos += m
    if ok and pos != n:
        ok = False
        log(f"FATAL: linearized {pos} rows, expected {n}")
    verify_s = time.time() - t0
    log(f"verified in {verify_s:.1f}s: {'EXACT' if ok else 'MISMATCH'}")

    for a in outputs:
        a.destroy()

    total_s = time.time() - t_start
    rate = n / sort_s
    print(json.dumps({
        "metric": f"out_of_core_{'kv' + str(pb) + 'B' if pb else 'keys'}"
                  f"_w{args.width}",
        "rows": n,
        "row_bytes": row_bytes,
        "sort_s": round(sort_s, 1),
        "rows_per_s": round(rate, 1),
        "exact": ok,
        "total_s": round(total_s, 1),
        "phases": stats.report(),
    }))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
