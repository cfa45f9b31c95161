"""Serving subsystem of the port: paged KV cache (int8 through the Hopper
quantize kernel), continuous-batching engine, multi-replica router."""
from repro_torch.serve.engine import (Clock, Completion, Engine,  # noqa: F401
                                      Request, ServeConfig, SimClock,
                                      SimCosts, latency_summary,
                                      poisson_trace, run_static)
from repro_torch.serve.kv_cache import (PageAllocator,  # noqa: F401
                                        PagedDecodeCache, TRASH_PAGE)
from repro_torch.serve.sharded import (LeastLoadedRouter,  # noqa: F401
                                       MultiReplicaServer)
