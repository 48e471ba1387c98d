"""The benchmark's frozen arithmetic: published peaks, model FLOPs, the
linears a step runs, and each kernel's least time.

Copied, not imported, from the program (``launch/roofline.py``'s
``active_params``/``recurrence_flops``/``model_flops``; ``chip_smoke.py``'s
``crossbar_bound_ms`` and the 37-term dot program's gate count), so that a
change to the program cannot move the yardstick.
Every function here is host arithmetic on a configuration's sizes."""
from __future__ import annotations

import math
from typing import List, Tuple

from bench.reference.arch import Arch

# H100 SXM published peaks (NVIDIA data sheet; dense; at 700 W)
PEAK_INT8_OPS = 1979e12           # int8 tensor-core operations per second
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer logic on the INT32 lanes: 64 per SM per clock x 132 SMs x
# 1.98 GHz (NVIDIA H100 Tensor Core GPU Architecture white paper)
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# The crossbar simulator's layout of one 8-bit (7-bit offset) dot product:
# 37 terms per chunk, 256 rows per crossbar, 1024 columns of 8 32-bit
# words, and the 37-term program's 86,320 gates of 4 int32 fields each.
PIM_TERMS = 37
PIM_ROWS = 256
PIM_COLS = 1024
PIM_WORDS = PIM_ROWS // 32
PIM_GATES = 86_320
PIM_GATE_FIELDS = 4

ATTN_KINDS = ("ad", "ae")
MLP_KINDS = ("ad", "md")
MOE_KINDS = ("ae", "me")
MAMBA_KINDS = ("md", "me")


# --------------------------------------------------------------------------
# model FLOPs
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# the linears a step runs, and their least times
# --------------------------------------------------------------------------

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


def quant_bound_s(m: int, k: int, n: int) -> float:
    """Least time of one int8 GEMM (M, K) x (K, N): its operations at the
    int8 peak, or int8 operands read once and the int32 result written
    once over HBM, whichever is longer."""
    return max(2.0 * m * k * n / PEAK_INT8_OPS,
               (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S)


def quant_bound_by(m: int, k: int, n: int) -> str:
    ops = 2.0 * m * k * n / PEAK_INT8_OPS
    return "operations" if ops >= quant_bound_s(m, k, n) else "bytes"


def pim_crossbars(m: int, k: int, o: int) -> int:
    """Crossbars one pim_sim linear at (M, K, O) runs on."""
    return math.ceil(k / PIM_TERMS) * math.ceil(m * o / PIM_ROWS)


def crossbar_bound_s(m: int, k: int, o: int) -> float:
    """Least time of one pim_sim linear on the crossbar kernel: the state
    read and written once and the program read once over HBM, or one
    32-bit logic operation per gate per row-word, whichever is longer."""
    c = pim_crossbars(m, k, o)
    t_bytes = (2 * c * PIM_COLS * PIM_WORDS * 4
               + PIM_GATES * PIM_GATE_FIELDS * 4) / HBM_BYTES_PER_S
    t_ops = PIM_GATES * c * PIM_WORDS / INT32_OPS_PER_S
    return max(t_bytes, t_ops)


def crossbar_bound_by(m: int, k: int, o: int) -> str:
    c = pim_crossbars(m, k, o)
    t_ops = PIM_GATES * c * PIM_WORDS / INT32_OPS_PER_S
    return "operations" if t_ops >= crossbar_bound_s(m, k, o) else "bytes"


def linear_bound_s(a: Arch, rows: int, mode: str) -> float:
    """Least seconds of one step's linears over ``rows`` token rows in
    ``mode``'s kernel."""
    fn = quant_bound_s if mode == "quant" else crossbar_bound_s
    return sum(fn(rows, k, n) for k, n in step_linears(a))
