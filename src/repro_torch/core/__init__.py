"""The training step's communication layer, ported from ``repro/core``:
every compressor, every collective algorithm on ``torch.distributed``
process groups (one per mesh axis), the gradient synchronizer, and the
every-step sync strategy."""
from repro_torch.core.grad_sync import (  # noqa: F401
    GradientSynchronizer, PlanExecutor, SyncConfig, bucketize,
    plan_from_config)
from repro_torch.core.schedule.planner import BucketPlan, CommPlan  # noqa: F401
from repro_torch.core.strategy import (  # noqa: F401
    EveryStepScheduler, RoundAction, RoundScheduler, SCHEDULERS,
    SyncStrategy, get_scheduler, make_strategy)
