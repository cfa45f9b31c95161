"""Error feedback / residual accumulation (counterpart of
``repro/core/compression/error_feedback.py``, survey §3.2.1 Eq. 2a-2b).

    e_{t+1}     = g_t - g_hat_t            (what compression lost)
    g_hat_{t+1} = Q(g_{t+1} + e_{t+1})     (correct the next step)

``decay`` is the forgetting factor of Wu et al. 2018 (ECQ-SGD).
"""
from __future__ import annotations

import torch

from repro_torch.core.compression.base import Compressor


def apply_with_feedback(comp: Compressor, g, e, rng=None, decay: float = 1.0):
    """One EF step on a single leaf: returns (g_hat, e_new), the locally
    reconstructed gradient that enters the collective and the residual."""
    corrected = g.to(torch.float32) + decay * e
    payload, meta = comp.compress(corrected, rng)
    g_hat = comp.decompress(payload, meta)
    return g_hat, corrected - g_hat
