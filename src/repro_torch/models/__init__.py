"""Model stack of the port (gemma-2b family: GQA/MQA attention + gated MLP)."""
from repro_torch.models.model import Model, count_params  # noqa: F401
