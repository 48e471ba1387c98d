"""The default reference's model arithmetic: parameter counts, model FLOPs
and the linears a step runs, host arithmetic on a configuration's sizes.

Copied, not imported, from the program (``launch/roofline.py``'s
``active_params``/``recurrence_flops``/``model_flops``), so that a change
to the program cannot move the yardstick.  The modes' arithmetic (peaks,
each kernel's least time) is ``bench/harness/arith.py``'s."""
from __future__ import annotations

from typing import List, Tuple

from bench.reference.arch import Arch
from bench.reference.params import (ATTN_KINDS, MAMBA_KINDS, MLP_KINDS,
                                    MOE_KINDS)


def _block_params(kind: str, a: Arch) -> int:
    d, h, kv, hd = a.d_model, a.n_heads, a.n_kv_heads, a.hd
    n = 0
    if kind in ATTN_KINDS:
        n += d + 2 * d * h * hd + 2 * d * kv * hd
        if a.qkv_bias:
            n += h * hd + 2 * kv * hd
    if kind in MLP_KINDS:
        n += d + (3 if a.gated_mlp else 2) * d * a.d_ff
    if kind in MOE_KINDS:
        n += d + d * a.n_experts + 3 * a.n_experts * d * a.expert_width
    if kind in MAMBA_KINDS:
        di, ds, dc, r = a.d_inner, a.mamba_d_state, a.mamba_d_conv, a.dt_rank
        n += (d + d * 2 * di + dc * di + di + di * (r + 2 * ds) + r * di
              + di + di * ds + di + di * d)
    return n


def param_count(a: Arch) -> int:
    emb = (1 if a.tie_embeddings else 2) * a.padded_vocab * a.d_model
    return (emb + a.d_model
            + a.n_super * sum(_block_params(k, a) for k in a.pattern))


def _expert_params(a: Arch) -> int:
    n_moe = sum(1 for k in a.pattern if k in MOE_KINDS) * a.n_super
    return n_moe * a.n_experts * 3 * a.d_model * a.expert_width


def active_params(a: Arch) -> int:
    """Parameters a token reads: all but the embeddings and the experts it
    is not routed to."""
    ep = _expert_params(a)
    emb = (1 if a.tie_embeddings else 2) * a.padded_vocab * a.d_model
    return int(param_count(a) - emb - ep
               + ep * a.top_k / max(a.n_experts, 1))


def recurrence_flops(a: Arch, tokens: int) -> float:
    per = sum(6 * a.d_inner * a.mamba_d_state
              for k in a.pattern if k in MAMBA_KINDS)
    return float(per * a.n_super * tokens)


def model_flops(a: Arch, tokens: int) -> float:
    """2 N_active per token processed (prompt or generated), plus the
    recurrences'."""
    return 2.0 * active_params(a) * tokens + recurrence_flops(a, tokens)


def step_linears(a: Arch) -> List[Tuple[int, int]]:
    """(K, N) of every projection one token row passes through the
    program's linear layer, layer after layer: the attention projections
    and the dense MLP (experts and Mamba projections are plain
    products)."""
    d, h, kv, hd, ff = a.d_model, a.n_heads, a.n_kv_heads, a.hd, a.d_ff
    attn = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d)]
    mlp = [(d, ff), (ff, d)] + ([(d, ff)] if a.gated_mlp else [])
    per = {k: (attn if k in ATTN_KINDS else [])
           + (mlp if k in MLP_KINDS else []) for k in a.pattern}
    return [s for k in a.pattern for s in per[k]] * a.n_super
