"""The training step's communication layer, ported from ``repro/core``:
every compressor, every collective algorithm on ``torch.distributed``
process groups (one per mesh axis), the gradient synchronizer, the
round schedulers (every step, local SGD, LAG, push/pull) with their
strategies, the communication planner (``core/schedule``) and the shard
layout of sharded data parallelism (``core/shard_state.py``)."""
from repro_torch.core.grad_sync import (  # noqa: F401
    GradientSynchronizer, PlanExecutor, SyncConfig, bucketize,
    plan_from_config, sharded_plan_from_config)
from repro_torch.core.shard_state import ShardLayout  # noqa: F401
from repro_torch.core.parallelism import ParallelismSpec  # noqa: F401
from repro_torch.core.schedule.planner import BucketPlan, CommPlan  # noqa: F401
from repro_torch.core.local_sgd import (  # noqa: F401
    AsymmetricPushPullConfig, LocalSGDConfig, average_params,
    communication_rounds, should_sync)
from repro_torch.core.lag import (  # noqa: F401
    LAGConfig, init_lag_state, lag_trigger, lag_update_state)
from repro_torch.core.strategy import (  # noqa: F401
    EveryStepScheduler, LAGScheduler, LocalSGDScheduler, PushPullScheduler,
    RoundAction, RoundScheduler, SCHEDULERS, SyncStrategy, get_scheduler,
    make_strategy, register_scheduler)
