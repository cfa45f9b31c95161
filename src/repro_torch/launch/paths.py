"""Artifact locations of the port: the planner's records go under
``artifacts/comm_plans_torch/`` and the dry run's under
``artifacts/dryrun_torch/`` at the repository root (``artifacts/`` is not
committed), beside the reference's ``artifacts/comm_plans/`` and
``artifacts/dryrun/``, which the port never writes."""
from __future__ import annotations

import os

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                     ".."))

COMM_PLANS = os.path.join(_ROOT, "artifacts", "comm_plans_torch")
DRYRUN = os.path.join(_ROOT, "artifacts", "dryrun_torch")
