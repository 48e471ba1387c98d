"""The benchmark's reading of a configuration file: the sizes a forward pass
needs, with nothing taken from the program under test.

A configuration file (``bench/configs/<name>.json``) holds the fields of the
model as it is run under ``"model"``; :class:`Arch` keeps those the plain
reference and the frozen arithmetic read, with the defaults the program's
configuration type gives a field that the file leaves out."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Arch:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...] = ("ad",)
    head_dim: Optional[int] = None
    activation: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0
    dtype: str = "bfloat16"
    pad_vocab_multiple: int = 256
    max_seq_len: int = 8_192

    @classmethod
    def from_model(cls, model: dict) -> "Arch":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in model.items() if k in names}
        if "pattern" in kw:
            kw["pattern"] = tuple(kw["pattern"])
        return cls(**kw)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return -(-self.vocab_size // m) * m

    @property
    def n_super(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.n_layers} layers do not hold whole "
                             f"periods of {self.pattern}")
        return self.n_layers // len(self.pattern)

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def expert_width(self) -> int:
        return self.moe_d_ff or self.d_ff

    def expert_capacity(self, tokens: int) -> int:
        """Tokens one expert accepts out of ``tokens`` routed together:
        ``ceil(T * k * cf / E)``, at least 8 and at most ``T``."""
        c = math.ceil(tokens * self.top_k * self.capacity_factor
                      / self.n_experts)
        return min(tokens, max(c, 8))
