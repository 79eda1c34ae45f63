"""64-bit keys through the STORAGE plane (VERDICT r4 missing item 5 /
next-round item 6): 64/width LSD rounds over 8-byte order-encoded rows,
parametric across mem/file/device factories and the subprocess worker
(keyBits wire extension), checkpoint/resume included.  Beyond the
reference's u32-only surface (reference libsort/libsort.h:19)."""

import numpy as np
import pytest

from gpu_radix_sort_tpu.data import (
    DeviceArrayFactory,
    FileArrayFactory,
    MemArrayFactory,
    create_shape,
)
from gpu_radix_sort_tpu.parallel import (
    BucketReader,
    ReadOrder,
    load_checkpoint,
    make_kv_worker,
    resume_sort_distrib,
    sort_distrib_from_arr,
    sort_distrib_from_raw_kv64,
    sort_distrib_from_raw_u64,
)


@pytest.fixture(params=["mem", "file", "device"])
def factory(request, tmp_path):
    if request.param == "mem":
        return MemArrayFactory()
    if request.param == "file":
        return FileArrayFactory(str(tmp_path / "arrays"))
    return DeviceArrayFactory()


def _keys64(n, dtype, seed=7):
    rng = np.random.default_rng(seed)
    if dtype == np.uint64:
        return rng.integers(0, 1 << 64, n, dtype=np.uint64)
    if dtype == np.int64:
        return rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    # float64 incl. negatives, zeros, and +/- inf
    f = (rng.random(n) - 0.5) * 1e300
    f[:3] = [np.inf, -np.inf, 0.0]
    return f.astype(np.float64)


@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.float64])
def test_sort_distrib_from_raw_u64(factory, dtype):
    keys = _keys64(1111, dtype)
    got = sort_distrib_from_raw_u64(keys, "u64e2e", factory, width=8,
                                    nworker=2)
    assert got.dtype == keys.dtype
    np.testing.assert_array_equal(got, np.sort(keys))


@pytest.mark.parametrize("width,nworker", [(16, 2), (8, 3), (4, 2)])
def test_sort_distrib_u64_widths(width, nworker):
    keys = _keys64(2048 + 17, np.uint64, seed=width)
    got = sort_distrib_from_raw_u64(
        keys, f"u64w{width}", MemArrayFactory(), width=width, nworker=nworker
    )
    np.testing.assert_array_equal(got, np.sort(keys))


def test_kv64_stable_through_storage(factory):
    """Duplicate-heavy 64-bit keys + payload rows: ties keep input order
    (every round's digit argsort is stable)."""
    n, pb = 1021, 6
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 64, n, dtype=np.uint64) << np.uint64(58)
    keys |= rng.integers(0, 4, n, dtype=np.uint64)  # heavy ties everywhere
    payload = rng.integers(0, 256, (n, pb), dtype=np.uint8)
    gk, gp = sort_distrib_from_raw_kv64(
        keys, payload, "kv64e2e", factory, width=8, nworker=2
    )
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gp, payload[order])


def test_u64_subprocess_worker(tmp_path):
    """64-bit rounds over the JSON wire protocol (keyBits extension) +
    file plane, through a real worker subprocess."""
    from gpu_radix_sort_tpu.parallel.serverless import make_subprocess_worker

    mount = str(tmp_path / "shared")
    factory = FileArrayFactory(mount)
    keys = _keys64(257, np.uint64, seed=11)
    worker = make_subprocess_worker(mount, row_bytes=8, key_bits=64)
    got = sort_distrib_from_raw_u64(
        keys, "u64proc", factory, worker, width=16, nworker=2
    )
    np.testing.assert_array_equal(got, np.sort(keys))


def test_u64_checkpoint_resume(tmp_path):
    """total_bits survives the manifest; resume completes the remaining
    64-bit rounds after a mid-sort crash."""
    from gpu_radix_sort_tpu.ops.bits import encode_ordered_np64

    factory = FileArrayFactory(str(tmp_path / "arrays"))
    ckpt_dir = str(tmp_path / "ckpt")
    keys = _keys64(513, np.int64, seed=3)
    enc = np.ascontiguousarray(encode_ordered_np64(keys), dtype="<u8")
    arr_in = factory.create("u64ck.input", create_shape([keys.size * 8]))
    arr_in.write_part(0, enc.tobytes())
    arr_in.close()

    worker64 = make_kv_worker(8, key_bits=64)

    def crashing(refs, offset, width, out_name, fac):
        if out_name == "u64ck.s5.w0":  # die in round 6 of 8
            raise RuntimeError("injected crash")
        return worker64(refs, offset, width, out_name, fac)

    with pytest.raises(RuntimeError, match="injected crash"):
        sort_distrib_from_arr(
            [arr_in], "u64ck", factory, crashing,
            width=8, nworker=2, checkpoint_dir=ckpt_dir, row_bytes=8,
            total_bits=64,
        )
    manifest = load_checkpoint(ckpt_dir, "u64ck")
    assert manifest["completed_step"] == 4
    assert manifest["total_bits"] == 64
    assert manifest["row_bytes"] == 8

    outputs = resume_sort_distrib(
        "u64ck", factory, worker64, ckpt_dir, nworker=2
    )
    raw = BucketReader(outputs, ReadOrder.STRIDED).read()
    got_enc = np.frombuffer(raw, dtype="<u8")
    from gpu_radix_sort_tpu.ops.bits import decode_ordered_np64

    np.testing.assert_array_equal(
        decode_ordered_np64(got_enc, np.int64), np.sort(keys)
    )


def test_total_bits_validation():
    f = MemArrayFactory()
    arr = f.create("tbv.input", create_shape([16]))
    arr.write_part(0, b"\0" * 16)
    arr.close()
    w = make_kv_worker(8, key_bits=64)
    with pytest.raises(ValueError, match="total_bits"):
        sort_distrib_from_arr([arr], "tbv", f, w, width=8, row_bytes=8,
                              total_bits=48)
    with pytest.raises(ValueError, match="8-byte rows"):
        sort_distrib_from_arr([arr], "tbv", f, w, width=8, row_bytes=4,
                              total_bits=64)
    arr.destroy()
    with pytest.raises(ValueError, match="key_bits"):
        make_kv_worker(8, key_bits=48)([], 0, 8, "x", f)


def test_worker64_digit_window_validation():
    """Digit windows must sit inside one 32-bit word of the encoded key."""
    from gpu_radix_sort_tpu.parallel import local_distrib_worker_kv

    f = MemArrayFactory()
    with pytest.raises(ValueError, match="digit window"):
        local_distrib_worker_kv([], 60, 8, "x", f, row_bytes=8, key_bits=64)


def test_fused64_device_loop_matches_generic():
    """The fused u64 device loop (one program for all 64/width rounds,
    _sort_rounds_device_fused64) must reproduce the generic worker loop's
    output arrays BIT-IDENTICALLY: same names, same partition lens, same
    partition bytes (keys-only value order == stable order for keys)."""
    from gpu_radix_sort_tpu.ops.bits import encode_ordered_np64

    keys = _keys64(3000, np.uint64, seed=21)
    enc = np.ascontiguousarray(encode_ordered_np64(keys), dtype="<u8")

    def run(factory, worker, name):
        arr = factory.create(f"{name}.input", create_shape([keys.size * 8]))
        arr.write_part(0, enc.tobytes())
        arr.close()
        return sort_distrib_from_arr(
            [arr], name, factory, worker, width=8, nworker=3,
            row_bytes=8, total_bits=64,
        )

    fast = make_kv_worker(8, key_bits=64)
    assert fast._fused64_ok

    def slow(*a, **k):  # unmarked wrapper -> generic worker loop
        return fast(*a, **k)

    f1, f2 = DeviceArrayFactory(), DeviceArrayFactory()
    out_fused = run(f1, fast, "fz")
    assert hasattr(out_fused[0], "_fused_linearize64")
    out_gen = run(f2, slow, "gz")
    assert len(out_fused) == len(out_gen) == 3
    for af, ag in zip(out_fused, out_gen):
        sf, sg = af.get_shape(), ag.get_shape()
        assert list(sf.lens) == list(sg.lens)
        assert bytes(af.read_all()) == bytes(ag.read_all())
    # the one-shot linearize hook yields the fully sorted stream
    got = np.frombuffer(
        out_fused[0]._fused_linearize64(), dtype="<u8"
    )
    from gpu_radix_sort_tpu.ops.bits import decode_ordered_np64

    np.testing.assert_array_equal(
        decode_ordered_np64(got, np.uint64), np.sort(keys)
    )


def test_fused64_disengages_under_checkpointing(tmp_path):
    """checkpoint_dir observes intermediate rounds, so the fused u64
    device loop must NOT engage — the generic worker loop runs (and
    resume completes) even on the device factory."""
    from gpu_radix_sort_tpu.ops.bits import (
        decode_ordered_np64, encode_ordered_np64,
    )

    factory = DeviceArrayFactory()
    ckpt_dir = str(tmp_path / "ckpt")
    keys = _keys64(700, np.uint64, seed=33)
    enc = np.ascontiguousarray(encode_ordered_np64(keys), dtype="<u8")
    arr_in = factory.create("dck.input", create_shape([keys.size * 8]))
    arr_in.write_part(0, enc.tobytes())
    arr_in.close()

    worker64 = make_kv_worker(8, key_bits=64)

    def crashing(refs, offset, width, out_name, fac):
        if out_name == "dck.s3.w1":
            raise RuntimeError("injected crash")
        return worker64(refs, offset, width, out_name, fac)

    crashing._fused64_ok = True  # even marked, checkpointing must bypass
    with pytest.raises(RuntimeError, match="injected crash"):
        sort_distrib_from_arr(
            [arr_in], "dck", factory, crashing,
            width=16, nworker=2, checkpoint_dir=ckpt_dir, row_bytes=8,
            total_bits=64,
        )
    manifest = load_checkpoint(ckpt_dir, "dck")
    assert manifest["completed_step"] == 2 and manifest["total_bits"] == 64
    outputs = resume_sort_distrib("dck", factory, worker64, ckpt_dir,
                                  nworker=2)
    assert not hasattr(outputs[0], "_fused_linearize64")
    raw = BucketReader(outputs, ReadOrder.STRIDED).read()
    got = decode_ordered_np64(np.frombuffer(raw, dtype="<u8"), np.uint64)
    np.testing.assert_array_equal(got, np.sort(keys))
