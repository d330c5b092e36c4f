from snvc_tpu_torch.parallel.api import (  # noqa: F401
    Mesh,
    global_sum,
    initialize_multihost,
    instance_batch_specs,
    make_mesh,
    process_index,
    shard_batch,
    shard_instance_batch,
)
