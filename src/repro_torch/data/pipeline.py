"""Deterministic synthetic LM data pipeline (numpy; the reference's own
arrays, bit for bit).

Stateless indexing: ``batch_at(step)`` is a pure function of
``(seed, step, shard)``, so resume-after-failure needs only the step number
from the checkpoint manifest — no iterator state to persist, no skip-ahead
replay cost.  Each host materializes only its shard's rows.

The stream is learnable (so smoke-training shows loss decrease): a seeded
token-bigram chain over the vocabulary with periodic copy spans.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["SyntheticLM", "AudioStub", "VisionStub"]


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard_index: int = 0
    shard_count: int = 1
    copy_span: int = 8

    def __post_init__(self):
        assert self.global_batch % self.shard_count == 0
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # sparse bigram successor table: each token has 4 likely successors
        self._succ = rng.integers(0, v, size=(v, 4), dtype=np.int32)

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.shard_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b, s, v = self.local_batch, self.seq_len, self.vocab_size
        rng = np.random.default_rng(
            (self.seed, step, self.shard_index, 0xD5EED))
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        choices = rng.integers(0, 4, size=(b, s))
        jumps = rng.random((b, s)) < 0.05
        jump_to = rng.integers(0, v, size=(b, s))
        for t in range(s):
            nxt = self._succ[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(jumps[:, t], jump_to[:, t], nxt)
        # periodic copy spans to give the model an easy sub-task
        span = self.copy_span
        if s >= 4 * span:
            start = rng.integers(span, s - 2 * span, size=b)
            for i in range(b):
                st = start[i]
                toks[i, st + span:st + 2 * span] = toks[i, st:st + span]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@dataclasses.dataclass
class AudioStub:
    """Precomputed frame-embedding stub for the audio frontend (the
    encoder-decoder configs' ``"frames"``)."""

    d_model: int
    frames: int

    def batch_at(self, step: int, batch: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng((seed, step, 0xA0D10))
        return rng.normal(size=(batch, self.frames, self.d_model)).astype(
            np.float32) * 0.02


@dataclasses.dataclass
class VisionStub:
    """Precomputed patch-embedding stub for the vision tower (the vision
    configs' ``"patches"``)."""

    vision_dim: int
    n_patches: int

    def batch_at(self, step: int, batch: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng((seed, step, 0x5EE1))
        return rng.normal(size=(batch, self.n_patches, self.vision_dim)
                          ).astype(np.float32) * 0.02
