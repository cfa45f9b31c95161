from repro_torch.core.collectives.api import (  # noqa: F401
    ALGOS, all_gather, allreduce, world_size)
