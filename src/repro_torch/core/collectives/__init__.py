from repro_torch.core.collectives.api import (  # noqa: F401
    ALGOS, all_gather, all_gather_shards, all_to_all, allreduce, as_axes,
    axes_for_topology,
    local_chunk, my_chunk_index, nested_shard_len, pad_to_chunks,
    reduce_scatter, send_recv, world_size)
from repro_torch.core.collectives.ring import (  # noqa: F401
    ring_all_gather_canonical, ring_all_gather_chunks, ring_allreduce,
    ring_reduce_scatter, ring_reduce_scatter_canonical)
from repro_torch.core.collectives.ring_fused import ring_fused_allreduce  # noqa: F401
from repro_torch.core.collectives.tree import tree_allreduce  # noqa: F401
from repro_torch.core.collectives.hierarchical import hierarchical_allreduce  # noqa: F401
from repro_torch.core.collectives.mesh2d import mesh2d_allreduce  # noqa: F401
