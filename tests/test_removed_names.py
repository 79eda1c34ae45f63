"""Names of removed kernels raise at every entry point that took them.

The Pallas sort kernels (strategies ``pallas``, ``pallas_merge``,
``pallas_radix``), the remote-DMA exchanges (``rdma``, ``rdma_overlap``)
and the merge-network reassembly (``merge``) are gone.  Asking for one is a
ValueError that says so — nothing runs in its place."""

import jax
import numpy as np
import pytest

import gpu_radix_sort_tpu as gst
from gpu_radix_sort_tpu.ops.radix_sort import REMOVED_STRATEGIES
from gpu_radix_sort_tpu.parallel import distributed, key_mesh, sample_sort
from gpu_radix_sort_tpu.parallel.distributed import REMOVED_EXCHANGES
from gpu_radix_sort_tpu.parallel.sample_sort import REMOVED_REASSEMBLIES
from gpu_radix_sort_tpu.utils.config import SortConfig

KEYS = np.arange(64, dtype=np.uint32)[::-1].copy()

STRATEGY_ENTRY_POINTS = {
    "sort_full": lambda s: gst.sort_full(KEYS, strategy=s),
    "sort_by_digits": lambda s: gst.sort_by_digits(KEYS, 0, 4, strategy=s),
    "sort_by_digits_unstable": lambda s: gst.sort_by_digits(
        KEYS, 0, 4, strategy=s, stable=False),
    "sort_partial": lambda s: gst.sort_partial(KEYS, 0, 4, strategy=s),
    "sort_partial_counts": lambda s: gst.sort_partial_counts(
        KEYS, 0, 4, strategy=s),
    "sort_key_value": lambda s: gst.sort_key_value(KEYS, KEYS, strategy=s),
    "sort_key_value_by_digits": lambda s: gst.sort_key_value_by_digits(
        KEYS, KEYS, 0, 4, strategy=s),
    "set_default_strategy": gst.set_default_strategy,
    "SortConfig": lambda s: SortConfig(strategy=s).validate(),
    "build_distributed_sort": lambda s: distributed.build_distributed_sort(
        key_mesh(jax.devices()[:2]), 32, width=8, exchange="alltoall",
        strategy=s),
}


@pytest.mark.parametrize("entry", sorted(STRATEGY_ENTRY_POINTS))
@pytest.mark.parametrize("strategy", REMOVED_STRATEGIES)
def test_removed_strategy_raises(strategy, entry):
    with pytest.raises(ValueError, match="removed"):
        STRATEGY_ENTRY_POINTS[entry](strategy)
    assert gst.get_default_strategy() == "auto"


EXCHANGE_ENTRY_POINTS = {
    "build_distributed_sort": lambda e: distributed.build_distributed_sort(
        key_mesh(jax.devices()[:2]), 32, width=8, exchange=e),
    "sort_distributed": lambda e: distributed.sort_distributed(
        KEYS, mesh=key_mesh(jax.devices()[:2]), width=8, exchange=e),
    "SortConfig": lambda e: SortConfig(exchange=e).validate(),
}


@pytest.mark.parametrize("entry", sorted(EXCHANGE_ENTRY_POINTS))
@pytest.mark.parametrize("exchange", REMOVED_EXCHANGES)
def test_removed_exchange_raises(exchange, entry):
    with pytest.raises(ValueError, match="removed"):
        EXCHANGE_ENTRY_POINTS[entry](exchange)


REASSEMBLY_ENTRY_POINTS = {
    "build_sample_sort": lambda r: sample_sort.build_sample_sort(
        key_mesh(jax.devices()[:2]), 64, reassembly=r),
    "sort_distributed_sample": lambda r: sample_sort.sort_distributed_sample(
        KEYS, mesh=key_mesh(jax.devices()[:2]), reassembly=r),
}


@pytest.mark.parametrize("entry", sorted(REASSEMBLY_ENTRY_POINTS))
@pytest.mark.parametrize("reassembly", REMOVED_REASSEMBLIES)
def test_removed_reassembly_raises(reassembly, entry):
    with pytest.raises(ValueError, match="removed"):
        REASSEMBLY_ENTRY_POINTS[entry](reassembly)


@pytest.mark.parametrize("strategy", [None, "auto", "xla"])
def test_remaining_strategies_run_xla(strategy):
    np.testing.assert_array_equal(
        np.asarray(gst.sort_full(KEYS, strategy=strategy)), np.sort(KEYS))


def test_unknown_names_still_rejected():
    with pytest.raises(ValueError, match="strategy must be one of"):
        gst.sort_full(KEYS, strategy="cuda")
    with pytest.raises(ValueError, match="exchange must be one of"):
        distributed.check_exchange("nccl")
    with pytest.raises(ValueError, match="reassembly must be"):
        sample_sort.check_reassembly("bogus")


def test_removed_modules_are_gone():
    import importlib

    for mod in ("gpu_radix_sort_tpu.ops.pallas_sort",
                "gpu_radix_sort_tpu.ops.pallas_merge",
                "gpu_radix_sort_tpu.ops.pallas_radix",
                "gpu_radix_sort_tpu.parallel.rdma_exchange",
                "gpu_radix_sort_tpu.parallel.rdma_overlap"):
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(mod)
