from .mesh import (  # noqa: F401
    STATS,
    allreduce_processes,
    compute_devices,
    init_distributed,
    local_mesh,
    make_mesh,
    shard_adapter_scan,
    shard_hw_block,
    shard_match_full,
    shard_match_full_mp,
    shard_match_min,
)
