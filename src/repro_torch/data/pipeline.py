"""Synthetic sharded token pipeline — a copy of ``repro/data/pipeline.py``
(numpy only; the port cannot import it, since any ``repro.*`` import loads
jax).  ``tests/test_torch_training.py`` pins the copy to the original.

Deterministic, seekable, host-side generation of LM batches (and stub frame
embeddings for the audio arch): each global step's batch is a pure function
of (seed, step), so every data-parallel host can slice its own shard without
coordination and checkpoints can resume mid-stream.  Mirrors the structure
of a real pipeline (shard -> batch -> device layout) without shipping a
tokenizer; examples use a tiny synthetic "language" whose bigram structure
gives optimizers something learnable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embedding_dim: int = 0     # >0: also emit "src" frame embeddings (audio stub)
    structured: bool = True    # learnable bigram structure vs uniform noise


class SyntheticPipeline:
    """``batch(step)`` -> {"tokens": (B, T) int32 [, "src": (B, T, d) f32]}."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # a fixed sparse bigram transition table: next ~ (a * cur + b) % V
        # with noise — cheap, stationary, and learnable by a tiny model.
        self._a = int(rng.integers(3, 17)) * 2 + 1
        self._b = int(rng.integers(1, cfg.vocab_size))

    def batch(self, step: int, host_id: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % num_hosts == 0
        local = cfg.global_batch // num_hosts
        rng = np.random.default_rng((cfg.seed, step, host_id))
        if cfg.structured:
            first = rng.integers(0, cfg.vocab_size, size=(local, 1))
            toks = [first]
            cur = first
            for _ in range(cfg.seq_len - 1):
                noise = rng.integers(0, cfg.vocab_size, size=(local, 1))
                flip = rng.random((local, 1)) < 0.1
                nxt = (self._a * cur + self._b) % cfg.vocab_size
                cur = np.where(flip, noise, nxt)
                toks.append(cur)
            tokens = np.concatenate(toks, axis=1).astype(np.int32)
        else:
            tokens = rng.integers(0, cfg.vocab_size,
                                  size=(local, cfg.seq_len), dtype=np.int32)
        out = {"tokens": tokens}
        if cfg.embedding_dim:
            out["src"] = rng.standard_normal(
                (local, cfg.seq_len, cfg.embedding_dim)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
