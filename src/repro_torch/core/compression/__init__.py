from repro_torch.core.compression.base import (  # noqa: F401
    Compressor, get_compressor, identity_compressor, REGISTRY)
from repro_torch.core.compression import (  # noqa: F401
    fused, lowrank, quantization, sparsification)
from repro_torch.core.compression.error_feedback import (  # noqa: F401
    apply_with_feedback)
