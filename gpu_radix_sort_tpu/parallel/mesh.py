"""Device-mesh helpers.

The reference scales by assigning workers to GPUs with semaphore+CAS device
reservation (libsort/utils.cu:34-61, benchmark/pkg/faas/invoke.go:21-65);
under JAX one process owns all chips, so "which device" becomes "which mesh
axis".  These helpers build the meshes every distributed entry point shards
over:

  * 1D ``("x",)`` mesh — key partitioning across all chips (the reference's
    ``nworker`` data split, distrib.go:107, generalized from 2 to N).
  * 2D ``("host", "chip")`` mesh — hierarchical layout so exchanges can be
    staged within a host before crossing hosts.  Within one host every
    device reaches every other at the same rate (NVLink, all to all), so
    the 1D mesh follows the algorithm alone and assumes no torus.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

KEY_AXIS = "x"


def key_mesh(devices=None) -> Mesh:
    """1D mesh over all (or given) devices; axis "x" partitions the keys."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (KEY_AXIS,))


def host_chip_mesh(devices=None, hosts: int | None = None) -> Mesh:
    """2D (host, chip) mesh. ``hosts`` defaults to jax.process_count()."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    nhosts = hosts or max(jax.process_count(), 1)
    if devices.size % nhosts:
        raise ValueError(f"{devices.size} devices not divisible by {nhosts} hosts")
    return Mesh(devices.reshape(nhosts, -1), ("host", "chip"))


def shard_along(mesh: Mesh, axis: str = KEY_AXIS) -> NamedSharding:
    """Sharding that splits axis 0 of an array across ``axis``."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def axis_size(mesh: Mesh, axis: str = KEY_AXIS) -> int:
    return mesh.shape[axis]
