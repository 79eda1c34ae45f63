"""Device-resident backend for DistribArray.

No reference equivalent — the GPU reference always round-trips bucket data
through host storage (mem.go / file.go) between rounds, paying H2D/D2H each
round (~46% of its partial-sort GPU time, SURVEY.md §3).  The natural home
for hot intermediate buckets is device memory: this backend keeps each partition
as a device-resident uint8 ``jax.Array`` so the storage-mediated
orchestration path (parallel/storage_sort.py) can run rounds without pulling
key payloads back to host until the final linearization.

Semantics match the other backends (append-only fixed-cap partitions,
single writer, commit on close); appends stage in a host buffer and are
flushed to device on ``close()`` (one transfer per partition, not per
write).  Readers slice on device and materialize bytes only when ``read``
is called; ``device_slice`` exposes the zero-copy device view for consumers
that stay on device.
"""

from __future__ import annotations

import threading

import numpy as np

from .interface import (
    ArrayFactory,
    CapacityError,
    DistribArray,
    DistribArrayShape,
    PartReader,
    PartWriter,
)


class _DevicePartReader(PartReader):
    def __init__(self, dev_part, start: int, nbyte: int):
        self._dev = dev_part
        self._pos = start
        self._end = start + nbyte

    def read(self, n: int = -1) -> bytes:
        import jax

        avail = self._end - self._pos
        if n is None or n < 0 or n > avail:
            n = avail
        if n == 0:
            return b""
        chunk = jax.device_get(self._dev[self._pos : self._pos + n])
        self._pos += n
        return np.asarray(chunk, dtype=np.uint8).tobytes()


class _DevicePartWriter(PartWriter):
    def __init__(self, arr: "DeviceDistribArray", part_idx: int):
        self._arr = arr
        self._idx = part_idx

    def write(self, data: bytes) -> int:
        return self._arr._append(self._idx, data)


class DeviceDistribArray(DistribArray):
    device_native = True  # capability flag: zero-copy device commit/fetch

    def __init__(self, name: str, shape: DistribArrayShape, device=None):
        import jax

        self._name = name
        self._caps = shape.caps
        self._device = device or jax.devices()[0]
        self._dev_parts: list = [None] * shape.npart  # committed device data
        # Packed commit path: one u8 backing array + per-partition offsets
        # (zero per-partition device ops at commit time).
        self._backing = None
        self._offsets: list[int] | None = None
        self._lens = [0] * shape.npart  # committed lengths
        self._pending: list[bytearray] = [bytearray() for _ in range(shape.npart)]
        self._lock = threading.Lock()
        self._destroyed = False

    @property
    def name(self) -> str:
        return self._name

    def _check_alive(self) -> None:
        if self._destroyed:
            raise IOError(f"array {self._name!r} has been destroyed")

    def _append(self, idx: int, data: bytes) -> int:
        with self._lock:
            self._check_alive()
            if self._backing is not None:
                raise IOError(
                    f"{self._name}[{idx}]: array committed via "
                    "put_device_packed; partitions are immutable"
                )
            total = self._lens[idx] + len(self._pending[idx]) + len(data)
            if total > self._caps[idx]:
                raise CapacityError(
                    f"{self._name}[{idx}]: write of {len(data)} bytes exceeds "
                    f"cap {self._caps[idx]}"
                )
            self._pending[idx].extend(data)
            return len(data)

    def put_device_part(self, idx: int, dev_array) -> None:
        """Commit an already-on-device uint8 array as partition ``idx``'s
        content directly — the zero-host-copy write path for producers whose
        output is already in HBM (e.g. a jitted partial sort)."""
        import jax.numpy as jnp

        with self._lock:
            self._check_alive()
            if self._backing is not None:
                # Without this guard a per-part commit after a packed commit
                # would pass the length checks but be shadowed by the
                # backing in _part_view — served as ANOTHER partition's
                # bytes, silently.
                raise IOError(
                    f"{self._name}[{idx}]: array committed via "
                    "put_device_packed; partitions are immutable"
                )
            if (
                self._lens[idx]
                or self._pending[idx]
                or self._dev_parts[idx] is not None  # zero-length commit
            ):
                raise IOError(f"{self._name}[{idx}]: partition already written")
            if dev_array.dtype != jnp.uint8 or dev_array.ndim != 1:
                raise ValueError("device part must be a 1-D uint8 array")
            if dev_array.shape[0] > self._caps[idx]:
                raise CapacityError(
                    f"{self._name}[{idx}]: {dev_array.shape[0]} bytes exceeds "
                    f"cap {self._caps[idx]}"
                )
            self._dev_parts[idx] = dev_array
            self._lens[idx] = int(dev_array.shape[0])

    def put_device_packed(self, backing, lens) -> None:
        """Commit ALL partitions at once as views over one on-device uint8
        ``backing`` array (partition d = backing[sum(lens[:d]) : +lens[d]]).
        The zero-host-copy, zero-per-partition-op commit path used by the
        device-native round loop: the round's jitted sort output stays in
        device memory and no per-bucket slicing programs are dispatched."""
        import jax.numpy as jnp

        lens = [int(x) for x in lens]
        with self._lock:
            self._check_alive()
            if (
                any(self._lens)
                or any(self._pending)
                or self._backing is not None
                or any(p is not None for p in self._dev_parts)
            ):
                raise IOError(f"{self._name}: array already written")
            if len(lens) != len(self._caps):
                raise ValueError(
                    f"{self._name}: {len(lens)} lens for {len(self._caps)} parts"
                )
            if backing.dtype != jnp.uint8 or backing.ndim != 1:
                raise ValueError("backing must be a 1-D uint8 device array")
            if sum(lens) != int(backing.shape[0]):
                raise ValueError(
                    f"{self._name}: lens sum {sum(lens)} != backing "
                    f"{backing.shape[0]}"
                )
            for d, (ln, cap) in enumerate(zip(lens, self._caps)):
                if ln > cap:
                    raise CapacityError(
                        f"{self._name}[{d}]: {ln} bytes exceeds cap {cap}"
                    )
            offs, pos = [], 0
            for ln in lens:
                offs.append(pos)
                pos += ln
            self._backing = backing
            self._offsets = offs
            self._lens = lens

    def _part_view(self, idx: int):
        """Committed u8 device data of a partition (None when empty/unset).
        Packed arrays slice the backing lazily (one async device op)."""
        if self._backing is not None:
            ln = self._lens[idx]
            if not ln:
                return None
            o = self._offsets[idx]
            return self._backing[o : o + ln]
        return self._dev_parts[idx]

    def device_range(self, idx: int, start: int = 0, nbyte: int = -1):
        """u8 device view of partition bytes [start, start+nbyte)
        (nbyte < 0 = to end) — the zero-host-copy fetch path.  For packed
        arrays this is a single lazy slice of the backing."""
        with self._lock:
            self._check_alive()
            ln = self._lens[idx]
            if nbyte < 0:
                nbyte = ln - start
            if start < 0 or nbyte < 0 or start + nbyte > ln:
                raise ValueError(
                    f"{self._name}[{idx}]: range [{start}, {start + nbyte}) "
                    f"out of committed len {ln}"
                )
            if self._backing is not None:
                o = self._offsets[idx] + start
                return self._backing[o : o + nbyte]
            import jax.numpy as jnp

            if self._dev_parts[idx] is None:
                return jnp.zeros((0,), jnp.uint8)
            return self._dev_parts[idx][start : start + nbyte]

    def device_slice(self, idx: int):
        """The committed device array for a partition (uint8[len])."""
        with self._lock:
            self._check_alive()
            return self._part_view(idx)

    def _flush(self) -> None:
        import jax
        import jax.numpy as jnp

        for idx in range(len(self._caps)):
            pend = self._pending[idx]
            if not pend:
                continue
            host = np.frombuffer(bytes(pend), dtype=np.uint8)
            new = jax.device_put(host, self._device)
            old = self._dev_parts[idx]
            if old is not None:
                new = jnp.concatenate([old, new])
            self._dev_parts[idx] = new
            self._lens[idx] += len(pend)
            self._pending[idx] = bytearray()

    def get_shape(self) -> DistribArrayShape:
        with self._lock:
            self._check_alive()
            return DistribArrayShape(list(self._lens), self._caps)

    def get_part_reader(self, part_idx: int) -> PartReader:
        with self._lock:
            self._check_alive()
            dev = self._part_view(part_idx)
            ln = self._lens[part_idx]
        if dev is None:
            return _EmptyReader()
        return _DevicePartReader(dev, 0, ln)

    def get_part_range_reader(self, part_idx, start, end) -> PartReader:
        with self._lock:
            self._check_alive()
            dev = self._part_view(part_idx)
            ln = self._lens[part_idx]
        if end <= 0:
            end = ln + end
        if start < 0 or end < start or end > ln:
            raise ValueError(
                f"{self._name}[{part_idx}]: range [{start}, {end}) out of "
                f"committed len {ln}"
            )
        if dev is None:
            return _EmptyReader()
        return _DevicePartReader(dev, start, end - start)

    def get_part_writer(self, part_idx: int) -> PartWriter:
        self._check_alive()
        return _DevicePartWriter(self, part_idx)

    def close(self) -> None:
        with self._lock:
            self._check_alive()
            self._flush()

    def destroy(self) -> None:
        with self._lock:
            self._destroyed = True
            self._dev_parts = []
            self._pending = []
            self._backing = None
            self._offsets = None
        self._on_destroy()

    def _on_destroy(self) -> None:  # wired by the factory
        pass


class _EmptyReader(PartReader):
    def read(self, n: int = -1) -> bytes:
        return b""


class DeviceArrayFactory(ArrayFactory):
    """Factory keeping partitions in device HBM; registry-based open-by-name
    like the memory backend."""

    device_native = True  # round loops may use the zero-copy device path

    def __init__(self, device=None, registry: dict | None = None):
        self._device = device
        self._registry: dict[str, DeviceDistribArray] = (
            registry if registry is not None else {}
        )
        self._lock = threading.Lock()

    def create(self, name: str, shape: DistribArrayShape) -> DistribArray:
        arr = DeviceDistribArray(name, shape, device=self._device)
        with self._lock:
            if name in self._registry:
                raise FileExistsError(f"device array {name!r} already exists")
            self._registry[name] = arr

        def _on_destroy(reg=self._registry, lock=self._lock, nm=name, a=arr):
            with lock:
                if reg.get(nm) is a:
                    del reg[nm]

        arr._on_destroy = _on_destroy
        return arr

    def open(self, name: str) -> DistribArray:
        with self._lock:
            try:
                return self._registry[name]
            except KeyError:
                raise FileNotFoundError(f"no device array named {name!r}") from None
