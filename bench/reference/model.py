"""The plain reference: the forward pass of a configuration in float32 plain
PyTorch, one sequence at a time and layer by layer, with no kernel, cache,
batching or paging.  It imports nothing of the program under test.

What it computes is the configuration as it is run (``bench/configs``):

* every projection that the program lowers through its linear layer
  (attention ``wq``/``wk``/``wv``/``wo`` and the dense MLP) is a symmetric
  fixed-point product: activations quantized per row, weights per output
  column, to ``bits`` (8 for ``quant``, 7 for ``pim_sim``), the integer
  product exact (float64 holds it: |sum| < 2**53), rescaled as each mode
  rescales: ``(acc * x_scale) * w_scale`` in float32 (``quant``), or
  ``acc * (x_scale * w_scale)`` in float64 (``pim_sim``);
* the rest (embedding, norms, RoPE, attention, the MoE experts and router,
  the Mamba projections and scan, the unembedding) is float32, with TF32
  off;
* an MoE block routes each token to its ``top_k`` experts (softmax over
  the k logits, ties to the lower index); the tokens of a prompt are
  routed together under the expert capacity ``ceil(T k cf / E)`` (at
  least 8): an expert keeps the first ``capacity`` tokens that chose it,
  and the prompt's last token also when it overflows, as the serving
  program does; a generated token routes alone and is never dropped;
* sliding-window attention sees keys with ``q_pos - k_pos < window``.

:func:`served_logits` returns, for each sequence, the logits at every
position from the prompt's last token on: the logits that chose each
served token."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench.reference.arch import Arch
from bench.reference.params import (ATTN_KINDS, MAMBA_KINDS, MLP_KINDS,
                                    MOE_KINDS)

F32 = torch.float32
F64 = torch.float64
Q_BLOCK = 1024          # attention query rows per block
VOCAB_BLOCK = 8192      # unembedding rows per block


def quantize(x: torch.Tensor, axis: int, bits: int):
    """Symmetric quantization of float32 ``x`` along ``axis``: (integer
    values as float64, float32 scales keeping ``axis``); eps 1e-8, round
    half to even, clip to +-qmax."""
    qmax = 2 ** (bits - 1) - 1
    amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q.to(F64), scale


class Linear:
    """A weight (K, N) quantized once per output column; ``wide``: rescale
    in float64."""

    def __init__(self, w: torch.Tensor, bits: int, wide: bool):
        self.wq, self.ws = quantize(w.to(F32), 0, bits)
        self.bits, self.wide = bits, wide

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xq, xs = quantize(x, 1, self.bits)
        acc = xq @ self.wq
        if self.wide:
            return (acc * (xs * self.ws).to(F64)).to(F32)
        return acc.to(F32) * xs * self.ws


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * w.to(F32)


def act(name: str):
    return {"silu": F.silu, "relu": F.relu,
            "gelu": lambda t: F.gelu(t, approximate="tanh")}[name]


def rope(x, theta: float):
    """x: (L, H, D), positions 0..L-1, rotating the two halves."""
    n, _, d = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=F32,
                                          device=x.device) / d))
    ang = torch.arange(n, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(x, p, lin, a: Arch):
    n = x.shape[0]
    h, kv, hd = a.n_heads, a.n_kv_heads, a.hd
    hh = rms_norm(x, p["norm1"], a.norm_eps)
    q, k, v = (lin[name](hh) for name in ("wq", "wk", "wv"))
    if a.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(n, h, hd), a.rope_theta)
    k = rope(k.reshape(n, kv, hd), a.rope_theta)
    v = v.reshape(n, kv, hd)
    rep = h // kv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    kpos = torch.arange(n, device=x.device)
    outs = []
    for q0 in range(0, n, Q_BLOCK):
        qb = q[q0:q0 + Q_BLOCK]
        qpos = kpos[q0:q0 + Q_BLOCK]
        s = torch.einsum("qhd,khd->hqk", qb, k) / math.sqrt(hd)
        mask = qpos[:, None] >= kpos[None, :]
        if a.sliding_window:
            mask &= qpos[:, None] - kpos[None, :] < a.sliding_window
        s = torch.where(mask[None], s, -math.inf)
        outs.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v))
    out = torch.cat(outs).reshape(n, h * hd)
    return x + lin["wo"](out)


def mlp(x, p, lin, a: Arch):
    hh = rms_norm(x, p["norm2"], a.norm_eps)
    h = act(a.activation)(lin["w_in"](hh))
    if a.gated_mlp:
        h = h * lin["w_gate"](hh)
    return x + lin["w_out"](h)


def moe(x, p, a: Arch, n_prompt: int):
    hh = rms_norm(x, p["norm_moe"], a.norm_eps)
    n = hh.shape[0]
    logits = hh @ p["router"].to(F32)
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    w = torch.softmax(vals[:, :a.top_k], dim=-1)
    ids = ids[:, :a.top_k]
    cap = a.expert_capacity(n_prompt)
    out = torch.zeros_like(hh)
    f = act(a.activation)
    for e in range(a.n_experts):
        hit = (ids == e)
        tok = hit.any(-1)
        # the prompt's tokens queue for the expert in order
        rank = torch.cumsum(tok[:n_prompt].long(), 0) - 1
        keep = tok.clone()
        keep[:n_prompt] &= rank < cap
        keep[n_prompt - 1] = tok[n_prompt - 1]
        rows = torch.nonzero(keep)[:, 0]
        if rows.numel() == 0:
            continue
        xe = hh[rows]
        y = (f(xe @ p["w1"][e].to(F32)) * (xe @ p["w3"][e].to(F32))) \
            @ p["w2"][e].to(F32)
        out[rows] += y * (hit[rows] * w[rows]).sum(-1, keepdim=True)
    return x + out


def mamba(x, p, a: Arch):
    di, ds, dc, r = a.d_inner, a.mamba_d_state, a.mamba_d_conv, a.dt_rank
    n = x.shape[0]
    hh = rms_norm(x, p["norm_m"], a.norm_eps)
    xi, z = torch.split(hh @ p["in_proj"].to(F32), di, dim=-1)
    pad = torch.cat([torch.zeros((dc - 1, di), dtype=F32, device=x.device),
                     xi])
    conv = sum(pad[t:t + n] * p["conv_w"][t] for t in range(dc)) \
        + p["conv_b"]
    u = F.silu(conv)
    dt_r, b, c = torch.split(u @ p["x_proj"].to(F32), [r, ds, ds], dim=-1)
    dt = torch.logaddexp(dt_r @ p["dt_proj"] + p["dt_bias"],
                         torch.zeros((), device=x.device))
    da = torch.exp(dt[..., None] * -torch.exp(p["a_log"]))
    dbu = (dt * u)[..., None] * b[:, None, :]
    h = torch.zeros((di, ds), dtype=F32, device=x.device)
    ys = []
    for t in range(n):
        h = da[t] * h + dbu[t]
        ys.append(h @ c[t])
    y = (torch.stack(ys) + u * p["d_skip"]) * F.silu(z)
    return x + y @ p["out_proj"].to(F32)


def _layer(params: Dict, i: int, layer: int) -> Dict:
    return {k: v[layer] for k, v in params["blocks"][str(i)].items()}


def served_logits(params: Dict, a: Arch, seqs: Sequence[Tuple[torch.Tensor,
                                                              int]],
                  bits: int, wide: bool = False) -> List[torch.Tensor]:
    """For each ``(tokens (L,), n_prompt)``: float32 logits (L - n_prompt +
    1, vocab) at positions ``n_prompt - 1 .. L - 1``, the linears at
    ``bits`` (rescaled in float64 when ``wide``)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _served_logits(params, a, seqs, bits, wide)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _served_logits(params, a, seqs, bits, wide):
    xs = [params["embed"][t].to(F32) for t, _ in seqs]
    for layer in range(a.n_super):
        for i, kind in enumerate(a.pattern):
            p = _layer(params, i, layer)
            lin = {name: Linear(p[name], bits, wide) for name in
                   (("wq", "wk", "wv", "wo") if kind in ATTN_KINDS else ())
                   + (("w_in", "w_gate", "w_out") if kind in MLP_KINDS
                      and a.gated_mlp else ())
                   + (("w_in", "w_out") if kind in MLP_KINDS
                      and not a.gated_mlp else ())}
            for j, (x, (_, n_prompt)) in enumerate(zip(xs, seqs)):
                if kind in ATTN_KINDS:
                    x = attention(x, p, lin, a)
                if kind in MAMBA_KINDS:
                    x = mamba(x, p, a)
                if kind in MLP_KINDS:
                    x = mlp(x, p, lin, a)
                if kind in MOE_KINDS:
                    x = moe(x, p, a, n_prompt)
                xs[j] = x
            del lin
    table = params["embed"] if a.tie_embeddings else params["lm_head"]
    out = []
    for x, (_, n_prompt) in zip(xs, seqs):
        h = rms_norm(x[n_prompt - 1:], params["final_norm"], a.norm_eps)
        out.append(torch.cat([h @ table[v0:v0 + VOCAB_BLOCK].to(F32).T
                              for v0 in range(0, table.shape[0],
                                              VOCAB_BLOCK)], dim=-1))
    return out
