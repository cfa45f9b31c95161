"""The communication planner of the port (survey §3.3 + §4.1): the α-β
cost model, the tiered topology, the overlap model and the per-bucket /
rounds / parallelism search, copied from ``repro/core/schedule`` and held
to it by ``tests/test_torch_planner.py``.  Calibration (``calibrate_topology``,
``measure_compression_costs`` and the drift report) is ROADMAP.md queue 1,
item 11; ``resolve_cost_table`` lives in ``cost.py``."""
from repro_torch.core.schedule.cost import (  # noqa: F401
    DECODE_HBM_BW, LINK_PRESETS, CompressionCostTable, LinkParams,
    all_to_all_cost_s, allgather_cost_s, allreduce_cost_s,
    allreduce_phases, bucket_sync_cost_s, bucket_sync_phases,
    compressed_wire_bytes, decode_step_cost_s, p2p_cost_s,
    reduce_scatter_cost_s, resolve_cost_table, shard_gather_cost_s,
    straggler_penalty_s)
from repro_torch.core.schedule.topology import (  # noqa: F401
    TOPOLOGY_PRESETS, Tier, Topology, as_topology)
from repro_torch.core.schedule.perf_model import (  # noqa: F401
    LayerProfile, comm_time, iteration_time_fifo, iteration_time_wfbp,
    iteration_time_mg_wfbp, iteration_time_p3, iteration_time_tic,
    iteration_time_tac, wfbp_case)
from repro_torch.core.schedule.planner import (  # noqa: F401
    BUCKET_GRID, BucketPlan, Candidate, CommPlan, DEFAULT_CANDIDATES,
    DENSE_SMALL_BYTES, EP_GRID, ExpertAxis, LOCAL_SGD_STEP_INFLATION,
    MICRO_GRID, OPT_MOMENTS, PIPE_GRID, PipelineAxis, RoundSchedule,
    ServingPlan, StrategyPlan, TAU_GRID, TP_GRID, TensorAxis,
    expert_parallel_arm, fixed_config_plan, form_bucket_indices,
    model_axis_placements, opt_state_bytes_per_worker, pipeline_arm,
    pipeline_placements, plan, plan_cost_s, plan_rounds, plan_serving,
    profiles_from_grads, profiles_from_sizes, serial_round_plan,
    serving_placements, shard_gather_tail_s, tensor_parallel_arm)
from repro_torch.core.pipeline import (  # noqa: F401
    PIPE_FWD_FRACTION, aligned_order, aligned_ticks, balanced_cuts,
    bubble_fraction, schedule_1f1b, simulate_1f1b, stage_costs)
