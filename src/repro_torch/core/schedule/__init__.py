from repro_torch.core.schedule.planner import (  # noqa: F401
    BucketPlan, CommPlan, form_bucket_indices)
