"""gpu_radix_sort_tpu — a JAX sort-execution framework for GPUs.

A from-scratch JAX/XLA re-design of the capability surface of
jssmith/gpu-radix-sort (CUDA libsort + Go distributed radix sort + FaaS
workers): single-chip full/partial radix sort with group boundaries,
a pluggable distributed-array data plane, bulk-synchronous distributed
sort over a device mesh with all-to-all bucket exchange, pluggable
in-process/subprocess workers, key-value (payload) sort, skew-aware
partitioning, and a layered benchmark/profiling harness.
"""

from .ops.radix_sort import (
    sort_full,
    sort_full_u64,
    sort_partial,
    sort_partial_u64,
    sort_partial_counts,
    sort_partial_counts_u64,
    sort_by_digits,
    sort_key_value,
    sort_key_value_by_digits,
    sort_key_value_u64,
    set_default_strategy,
    get_default_strategy,
)
from .ops.boundaries import compute_boundaries, digit_counts, counts_to_boundaries
from .ops.bits import extract_digits
from .utils.keygen import (
    Pcg32,
    generate_keys,
    reset_global_stream,
    generate_zipf_keys,
    generate_payloads,
)

__version__ = "0.1.0"

__all__ = [
    "sort_full",
    "sort_full_u64",
    "sort_partial",
    "sort_partial_u64",
    "sort_partial_counts",
    "sort_partial_counts_u64",
    "sort_by_digits",
    "sort_key_value",
    "sort_key_value_by_digits",
    "sort_key_value_u64",
    "set_default_strategy",
    "get_default_strategy",
    "compute_boundaries",
    "digit_counts",
    "counts_to_boundaries",
    "extract_digits",
    "Pcg32",
    "generate_keys",
    "reset_global_stream",
    "generate_zipf_keys",
    "generate_payloads",
    "__version__",
]
