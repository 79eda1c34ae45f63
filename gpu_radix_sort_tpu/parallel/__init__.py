from . import distributed, exchange, mesh, sample_sort  # noqa: F401
from .distributed import build_distributed_sort, sort_distributed  # noqa: F401
from .mesh import key_mesh, host_chip_mesh  # noqa: F401
from .sample_sort import (  # noqa: F401
    build_sample_sort,
    build_sample_sort_64,
    build_sample_sort_kv,
    build_sample_sort_kv64,
    sort_distributed_64,
    sort_distributed_sample,
    sort_key_value_distributed,
    sort_key_value_distributed_64,
)
from .bucket_reader import BucketReader, ReadOrder  # noqa: F401
from .storage_sort import (  # noqa: F401
    DistribWorker,
    local_distrib_worker,
    local_distrib_worker_kv,
    make_kv_worker,
    make_local_worker,
    sort_distrib_from_arr,
    sort_distrib_from_raw,
    sort_distrib_from_raw_kv,
    sort_distrib_from_raw_kv64,
    sort_distrib_from_raw_u64,
    resume_sort_distrib,
    load_checkpoint,
)
from .pipeline import (  # noqa: F401
    build_hash_aggregate,
    hash_aggregate_distributed,
)
from .serverless import (  # noqa: F401
    WorkerPool,
    build_event,
    handle_event,
    invoke_subprocess,
    make_subprocess_worker,
    part_ref_to_wire,
    wire_to_part_ref,
)
