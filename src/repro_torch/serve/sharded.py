"""Multi-replica decode of the port — counterpart of ``repro/serve/sharded.py``.

Data-parallel serving: N independent :class:`~repro_torch.serve.engine.Engine`
replicas behind a load-aware router.  Each replica holds a full model
copy; requests are routed at submit time to the least-loaded replica,
ties broken round-robin so equal replicas share work deterministically.
The placement planner (``plan_serving`` in the reference) is not ported
yet.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.serve.engine import Completion, Engine, Request


class LeastLoadedRouter:
    """Pick the replica with the fewest outstanding requests; ties break
    round-robin so a burst at t=0 still spreads across replicas."""

    def __init__(self):
        self._rr = 0

    def pick(self, loads: Sequence[int]) -> int:
        lo = min(loads)
        tied = [i for i, l in enumerate(loads) if l == lo]
        choice = tied[self._rr % len(tied)]
        self._rr += 1
        return choice


class MultiReplicaServer:
    """Route each request to a replica at submit time, then tick every
    busy replica round-robin until the trace drains."""

    def __init__(self, engines: List[Engine],
                 router: Optional[LeastLoadedRouter] = None):
        if not engines:
            raise ValueError("need at least one engine")
        self.engines = engines
        self.router = router if router is not None else LeastLoadedRouter()
        self.routes: List[int] = []     # replica index per submitted request

    def submit(self, req: Request) -> int:
        idx = self.router.pick([e.load() for e in self.engines])
        self.engines[idx].submit(req)
        self.routes.append(idx)
        return idx

    def run(self, requests: Sequence[Request]) -> List[Completion]:
        for r in sorted(requests, key=lambda r: (r.arrival_s, r.rid)):
            self.submit(r)
        out: List[Completion] = []
        while any(e.busy() for e in self.engines):
            for e in self.engines:
                if e.busy():
                    out += e.step()
        for e in self.engines:
            e.cache.check()
        return sorted(out, key=lambda c: c.rid)
