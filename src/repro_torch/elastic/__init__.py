"""Elastic fault-tolerant training runtime of the port (counterpart of
``repro/elastic``, DESIGN.md §15): survive preemption, reshard across
world changes without restart, and demote the sync cadence under
stragglers instead of stalling the bus."""
from repro_torch.elastic.faults import (  # noqa: F401
    FaultEvent, FaultSchedule, replay_world_sizes)
from repro_torch.elastic.reshard import surviving_topology  # noqa: F401
from repro_torch.elastic.runtime import (  # noqa: F401
    ElasticConfig, ElasticRuntime, ReshardEvent, SimulatedExecutor,
    StepOutcome)
