"""Model configuration, with the reference's fields for every architecture
(the port runs every block kind below).

A model is a stack of *super-blocks*: ``pattern`` lists the layer kinds of
one period; the stack is ``n_layers / len(pattern)`` periods, with
parameters stacked per period (the port loops over them in Python).

Layer kinds:
    "ad"   self-attention + dense MLP
    "ae"   self-attention + MoE
    "ar"   self-attention + MoE with parallel dense-residual MLP (arctic)
    "adx"  self-attention + cross-attention + dense MLP (VLM / enc-dec)
    "md"   Mamba mixer + dense MLP
    "me"   Mamba mixer + MoE
    "ms"   Mamba-2 mixer + MoE beside a shared expert (granite-4.0-h)
    "as"   self-attention + MoE beside a shared expert (granite-4.0-h)
    "xm"   xLSTM mLSTM block (up-proj / matrix-memory / down-proj)
    "xs"   xLSTM sLSTM block
Encoder stacks (enc-dec models) are uniform "enc" self-attention blocks.

The fields after ``max_seq_len`` are the port's own (the reference has no
Mamba-2 mixer, shared expert or multiplier); their defaults leave every
other configuration as the reference computes it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig", "SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell (the dry run's and the roofline's)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...] = ("ad",)
    head_dim: Optional[int] = None
    activation: str = "silu"         # silu => SwiGLU, gelu => GeGLU
    gated_mlp: bool = True
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_fsdp_gather: bool = False    # ZeRO-3 experts: gather inside
                                     # shard_map (bwd = reduce-scatter)
    router_dtype: str = "float32"
    # Mamba
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0           # 0 => d_model // 16
    # xLSTM
    xlstm_proj_factor: float = 2.0
    # encoder-decoder (audio)
    n_encoder_layers: int = 0
    audio_frames_div: int = 4        # encoder frames = seq_len // div (stub)
    # VLM
    vision_dim: int = 0
    n_patches: int = 0
    # numerics / memory
    dtype: str = "bfloat16"
    pad_vocab_multiple: int = 256
    remat: bool = True
    scan_layers: bool = True
    flash_attention: bool = True     # False: materialized scores (exact
                                     # HLO flop accounting, dry-run only)
    kv_cache_dtype: str = "bf16"     # "int8": quantized KV cache
    loss_chunk: int = 8192
    unembed_chunk: int = 0           # vocab-axis chunk for the loss-path
                                     # unembed (0: single full-width einsum)
    # PIM lowering for every linear in the stack: None inherits the ambient
    # repro_torch.pim.engine.mode(...) context; "xla" | "quant" |
    # "quant_tp" | "pim_sim" pin it ("quant_tp" is "quant" without a mesh).
    pim_mode: Optional[str] = None
    # training
    max_seq_len: int = 8_192
    # port only: Mamba-2 ("ms"), the shared expert, muP multipliers, NoPE
    mamba_n_heads: int = 0           # Mamba-2 heads, each with its own decay
    shared_d_ff: int = 0             # the shared expert's width ("ms", "as")
    embedding_multiplier: float = 1.0   # the embedding's scale
    residual_multiplier: float = 1.0    # each sublayer's output's scale
                                        # before its residual add
    attention_multiplier: Optional[float] = None   # score scale (None:
                                                    # 1 / sqrt(head dim))
    logits_scaling: float = 1.0      # logits are divided by it
    use_rope: bool = True            # False: no positional encoding (NoPE)

    # ------------------------------------------------------------------
    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def n_super(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: {self.n_layers} layers not divisible by "
            f"pattern of {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_d_head(self) -> int:
        """A Mamba-2 head's width: d_inner over the heads."""
        return self.d_inner // self.mamba_n_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def has_recurrent_blocks(self) -> bool:
        """Any SSM/xLSTM block in the stack (state folds the whole prefix,
        so e.g. right-padded prompts are not admissible)."""
        return any(k in ("md", "me", "ms", "xm", "xs") for k in self.pattern)

    def window_ring_blocks(self, block_size: int) -> Optional[int]:
        """Blocks in a sliding-window decode ring (None when unwindowed).

        The ring capacity is the window rounded up to a whole number of
        blocks: a windowed slot never holds more than this many blocks, no
        matter how long the prompt or the generation runs."""
        if not self.sliding_window:
            return None
        return -(-self.sliding_window // block_size)

    def kv_blocks_for(self, n_tokens: int, block_size: int) -> int:
        """KV-cache blocks a request writing ``n_tokens`` positions needs.

        Unwindowed requests page linearly (``ceil(n_tokens / block)``);
        windowed ones are clamped to the ring capacity, which is the whole
        point of sliding-window serving: generation length stops mattering
        to the reservation."""
        nb = -(-max(int(n_tokens), 1) // block_size)
        ring = self.window_ring_blocks(block_size)
        return nb if ring is None else min(nb, ring)

    @property
    def sub_quadratic(self) -> bool:
        """Whether long-context decode is admissible: sliding-window
        attention bounds the cache; SSM/hybrid blocks keep O(1)/O(S)
        per-token state.  Pure full-attention stacks are not."""
        if self.sliding_window:
            return True
        return self.has_recurrent_blocks

    def runnable(self, shape: ShapeSpec) -> Tuple[bool, str]:
        """Whether an assigned (arch x shape) cell runs, and why not if
        not."""
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False, ("pure full attention: 500k decode needs "
                           "sub-quadratic")
        if shape.name == "long_500k" and self.is_encoder_decoder:
            return False, "enc-dec full attention (and out of domain at 500k)"
        return True, ""

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=len(self.pattern), d_model=64,
            n_heads=4, n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_ff=128 if self.d_ff else 0, vocab_size=277,
            head_dim=16, sliding_window=min(self.sliding_window, 16)
            if self.sliding_window else None,
            pad_vocab_multiple=8, loss_chunk=64, max_seq_len=64,
            dtype="float32", remat=False,
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(2, self.top_k), moe_d_ff=32)
        if self.n_encoder_layers:
            kw.update(n_encoder_layers=2)
        if self.vision_dim:
            kw.update(vision_dim=24, n_patches=9)
        if self.family == "ssm":
            kw.update(n_heads=2, n_kv_heads=2, head_dim=32)
        if self.mamba_n_heads:
            # Mamba-2: 4 heads of 16 (d_inner 64), 8 experts top 2
            kw.update(mamba_n_heads=4, mamba_expand=1,
                      mamba_d_state=16, n_experts=8, top_k=2,
                      shared_d_ff=48)
        return dataclasses.replace(self, **kw)
