"""gwkit_torch.parallel -- the ("data", "model") mesh and its sharding rules,
and several processes on ``torch.distributed`` (counterpart of
``gwkit.parallel``).

Training splits the batch over "data" and, optionally, the encoder's heads
and MLP width over "model" (Megatron, explicit collectives); the search
splits each batch's windows over "data", and its segments across processes
with the trigger lists merged through a shared directory.
"""
from gwkit_torch.parallel.distributed import (  # noqa: F401
    gather_trigger_lists,
    host_key_filter,
    initialize,
    merge_trigger_shards,
    process_count,
    process_index,
    shard_segments_across_hosts,
    write_trigger_shard,
)
from gwkit_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    adapter_sharding,
    batch_sharding,
    encoder_sharding,
    gather_tree,
    make_mesh,
    replicated,
    shard_params,
    shard_task_tree,
    task_shardings,
)
