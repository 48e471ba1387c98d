"""Primitive layers: norms, rotary embeddings, activations, linears, embed.

Parameters are plain nested dicts of tensors.

:func:`linear` is the paper integration point.  How it lowers is selected
through ``repro_torch.pim.engine`` — there is no process-wide global:

* ``"xla"``      — plain matmul (default; the name is the reference's);
* ``"quant"``    — the int8 GEMM kernel (fixed-point arithmetic, the GPU
  analogue of the crossbar's integer representation);
* ``"pim_sim"``  — the actual MultPIM gate programs on the bit-accurate
  crossbar simulator, via ``engine.sim_linear`` (the crossbar kernel on
  CUDA tensors);
* ``"quant_tp"`` — the int8 GEMM in per-rank tiles over the active mesh's
  ``"model"`` axis (``engine.get_backend("quant_tp")``); ``"quant"``
  exactly without a mesh.

Selection is either ambient — ``with pim.engine.mode("quant"): ...`` — or
threaded explicitly: ``linear(x, w, mode=...)``, normally fed from
``ModelConfig.pim_mode`` by the model stack.  An explicit mode wins over
the ambient context.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# norms / activations / rope
# --------------------------------------------------------------------------

def rms_norm(x, weight, eps: float):
    # statistics in f32; the (big) elementwise multiply stays in x.dtype
    xf = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return x * (scale.to(x.dtype) * weight.to(x.dtype))


def _gelu_tanh(x):
    # jax.nn.gelu's default is the tanh approximation, not the exact erf
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, Dh), positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, Dh/2)
    cos = torch.cos(ang)[..., None, :]  # (B, S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# linear / embedding (with PIM modes)
# --------------------------------------------------------------------------

def linear(x, w, b=None, *, mode: Optional[str] = None):
    """``x @ w (+ b)`` lowered per the active PIM mode.

    ``mode=None`` reads the ambient ``pim.engine.mode(...)`` context; an
    explicit ``mode`` (e.g. ``ModelConfig.pim_mode`` threaded by the model
    stack) takes precedence.
    """
    from repro_torch.pim import engine

    mode = engine.resolve_mode(mode)
    if mode == "quant":
        from repro_torch.kernels.quant_matmul import quant_linear

        y = quant_linear(x, w.to(torch.float32))
    elif mode == "quant_tp":
        y = engine.get_backend("quant_tp")(x, w)
    elif mode == "pim_sim":
        y = engine.sim_linear(x, w)
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def embed_lookup(table, ids):
    return table[ids]


def unembed(x, table, chunk: Optional[int] = None):
    """Logits = x @ table.T (table: (V, d)).

    ``chunk`` bounds the vocab-axis working set: the table is consumed in
    ``chunk``-row slices, so the compute-dtype copy of the table (and the
    product) peaks at ``chunk x d`` instead of ``V x d``.  The loss path
    threads ``ModelConfig.unembed_chunk`` here.  ``None``, ``<= 0`` or a
    chunk ``>= V`` is one full-width product.
    """
    v = table.shape[0]
    if chunk is None or chunk <= 0 or chunk >= v:
        return x @ table.to(x.dtype).T
    return torch.cat([x @ table[i:i + chunk].to(x.dtype).T
                      for i in range(0, v, chunk)], dim=-1)
