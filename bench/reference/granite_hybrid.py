"""The plain reference of granite-4.0-h (hf ``ibm-granite/granite-4.0-h-small``,
``model_type`` ``granitemoehybrid``): the block kinds ``ms`` (a Mamba-2
mixer) and ``as`` (self-attention), each followed by a top-k MoE beside a
shared expert, with the muP multipliers.  Float32 plain PyTorch, one
sequence at a time and layer by layer, with TF32 off; it imports nothing
of the program under test.  It exports what ``default.py``'s docstring
lists.

What it computes, per layer (``rm``: ``residual_multiplier``)::

    x += rm * mixer(rms_norm(x))              # Mamba-2 or attention
    h  = rms_norm(x)
    x += rm * (routed_experts(h) + shared_expert(h))

after ``x = embed[t] * embedding_multiplier``; the logits are
``rms_norm(x) @ embed.T / logits_scaling`` (tied).

* Mamba-2, one group: ``in_proj`` gives ``z`` (d_inner), ``xBC`` (d_inner
  + 2 d_state) and ``dt`` (one per head); a causal depthwise conv with bias
  and SiLU over ``xBC``, split into ``x`` (heads of ``mamba_d_head``),
  ``B`` and ``C``; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``
  per head; ``h = exp(dt A) h + dt x B^T``, ``y = h C + D x``; then
  ``rms_norm(y * silu(z)) * gate_norm`` over d_inner and ``out_proj``.
* Attention: GQA, causal, scores times ``attention_multiplier``
  (``1 / sqrt(head_dim)`` when None), RoPE only when ``use_rope`` (the
  published model has none).
* The MoE: the router's top ``top_k`` of ``n_experts`` logits, softmaxed,
  each token's experts' gated SiLU MLPs weighed by them; a prompt's
  tokens route together under the expert capacity (``default``'s rule,
  ``bench/reference/model.py``), a generated token alone.  The shared
  expert is a gated SiLU MLP of ``shared_d_ff`` on the same input.
* The projections the program lowers through its linear layer (the
  attention's ``wq``/``wk``/``wv``/``wo`` and the shared expert's
  ``w_in``/``w_gate``/``w_out``) are the symmetric fixed-point products
  of ``bench/reference/model.py``'s ``Linear`` at ``bits``; the rest
  (Mamba-2's projections and scan, the experts, the router, the norms,
  the embedding and the unembedding) is float32."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench.reference.model import (F32, Q_BLOCK, VOCAB_BLOCK, Linear, act,
                                   rms_norm, rope)
from bench.reference.params import generator

KINDS = ("ms", "as")
ATTN_KINDS = ("as",)
MAMBA2_KINDS = ("ms",)
ATTN_LINEARS = ("wq", "wk", "wv", "wo")
SHARED_LINEARS = ("w_in", "w_gate", "w_out")

PROGRAM_ONLY = {
    "name": "a label",
    "family": "the label the program's registry groups configurations by",
    "kv_cache_dtype": "how the serving pool stores keys and values; the "
                      "reference keeps no pool and recomputes them",
}


@dataclasses.dataclass(frozen=True)
class Arch:
    """The ``"model"`` fields this reference reads, with the program's
    defaults for a field the file leaves out."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...] = ("ms",)
    head_dim: Optional[int] = None
    activation: str = "silu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    shared_d_ff: int = 0
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    mamba_n_heads: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    logits_scaling: float = 1.0
    use_rope: bool = True
    rope_theta: float = 10_000.0
    dtype: str = "bfloat16"
    pad_vocab_multiple: int = 256
    max_seq_len: int = 8_192

    @classmethod
    def from_model(cls, model: dict) -> "Arch":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in model.items() if k in names}
        if "pattern" in kw:
            kw["pattern"] = tuple(kw["pattern"])
        a = cls(**kw)
        if a.mamba_n_heads and a.d_inner % a.mamba_n_heads:
            raise ValueError(f"d_inner {a.d_inner} is not "
                             f"{a.mamba_n_heads} Mamba-2 heads of one width")
        return a

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
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_d_head(self) -> int:
        return self.d_inner // self.mamba_n_heads

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.mamba_d_state

    @property
    def expert_width(self) -> int:
        return self.moe_d_ff or self.d_ff

    def expert_capacity(self, tokens: int) -> int:
        """Tokens one expert accepts out of ``tokens`` routed together:
        ``ceil(T * k * cf / E)``, at least 8 and at most ``T``."""
        c = math.ceil(tokens * self.top_k * self.capacity_factor
                      / self.n_experts)
        return min(tokens, max(c, 8))


# --------------------------------------------------------------------------
# the parameter tree, laid out as the program takes it
# --------------------------------------------------------------------------

Leaf = Tuple[Tuple[int, ...], torch.dtype, str, float]


def block_leaves(kind: str, a: Arch, dt) -> Dict[str, Leaf]:
    if kind not in KINDS:
        raise NotImplementedError(f"granite_hybrid draws no {kind!r} block")
    d, e, f, sf = a.d_model, a.n_experts, a.expert_width, a.shared_d_ff
    out: Dict[str, Leaf] = {
        "norm_moe": ((d,), F32, "ones", 1.0),
        "router": ((d, e), F32, "normal", 1.0),
        "w1": ((e, d, f), dt, "normal", 1.0),
        "w2": ((e, f, d), dt, "normal", 1.0),
        "w3": ((e, d, f), dt, "normal", 1.0),
        "w_in": ((d, sf), dt, "normal", 1.0),
        "w_gate": ((d, sf), dt, "normal", 1.0),
        "w_out": ((sf, d), dt, "normal", 1.0)}
    if kind in ATTN_KINDS:
        h, kv, hd = a.n_heads, a.n_kv_heads, a.hd
        out.update(norm1=((d,), F32, "ones", 1.0),
                   wq=((d, h * hd), dt, "normal", 1.0),
                   wk=((d, kv * hd), dt, "normal", 1.0),
                   wv=((d, kv * hd), dt, "normal", 1.0),
                   wo=((h * hd, d), dt, "normal", 1.0))
    else:
        di, ds, nh, c = a.d_inner, a.mamba_d_state, a.mamba_n_heads, \
            a.conv_dim
        out.update(norm_m=((d,), F32, "ones", 1.0),
                   in_proj=((d, di + c + nh), dt, "normal", 1.0),
                   conv_w=((a.mamba_d_conv, c), F32, "normal", 0.5),
                   conv_b=((c,), F32, "zeros", 1.0),
                   dt_bias=((nh,), F32, "zeros", 1.0),
                   a_log=((nh,), F32, "alog", 1.0),
                   d_skip=((nh,), F32, "ones", 1.0),
                   gate_norm=((di,), F32, "ones", 1.0),
                   out_proj=((di, d), dt, "normal", 1.0))
    return out


def leaves(a: Arch) -> Iterator[Tuple[Tuple[str, ...], Leaf]]:
    """``(path, (shape, dtype, init, scale))`` of every leaf, in sorted-path
    order."""
    dt = torch.bfloat16 if a.dtype == "bfloat16" else F32
    v, d, n = a.padded_vocab, a.d_model, a.n_super
    flat: Dict[Tuple[str, ...], Leaf] = {
        ("embed",): ((v, d), dt, "normal", 1.0),
        ("final_norm",): ((d,), F32, "ones", 1.0)}
    if not a.tie_embeddings:
        flat[("lm_head",)] = ((v, d), dt, "normal", 1.0)
    for i, kind in enumerate(a.pattern):
        for name, (shape, ldt, init, scale) in block_leaves(kind, a,
                                                            dt).items():
            flat[("blocks", str(i), name)] = ((n,) + shape, ldt, init, scale)
    return iter(sorted(flat.items()))


def draw(a: Arch, seed: int, device) -> Dict:
    """The parameter tree of ``a`` drawn from ``seed`` on ``device``: a
    normal leaf has standard deviation ``scale / sqrt(fan_in)`` (its
    second-to-last size), an ``"alog"`` leaf holds ``log(1..n)``."""
    device = torch.device(device)
    g = generator(seed, device)
    tree: Dict = {}
    for path, (shape, dt, init, scale) in leaves(a):
        if init == "zeros":
            t = torch.zeros(shape, dtype=dt, device=device)
        elif init == "ones":
            t = torch.ones(shape, dtype=dt, device=device)
        elif init == "alog":
            row = torch.log(torch.arange(1, shape[-1] + 1, dtype=F32,
                                         device=device))
            t = row.expand(shape).to(dt).contiguous()
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            t = torch.empty(shape, dtype=dt, device=device).normal_(
                0.0, scale / math.sqrt(max(1, fan_in)), generator=g)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


# --------------------------------------------------------------------------
# the forward pass
# --------------------------------------------------------------------------

def mamba2(hh, p, a: Arch):
    """The Mamba-2 mixer over one sequence's normed rows (L, d)."""
    n = hh.shape[0]
    di, ds, dc = a.d_inner, a.mamba_d_state, a.mamba_d_conv
    nh, hd = a.mamba_n_heads, a.mamba_d_head
    z, xbc, dt = torch.split(hh @ p["in_proj"].to(F32),
                             [di, a.conv_dim, nh], dim=-1)
    pad = torch.cat([torch.zeros((dc - 1, a.conv_dim), dtype=F32,
                                 device=hh.device), xbc])
    conv = sum(pad[t:t + n] * p["conv_w"][t] for t in range(dc)) \
        + p["conv_b"]
    x, b, c = torch.split(F.silu(conv), [di, ds, ds], dim=-1)
    x = x.reshape(n, nh, hd)
    dt = F.softplus(dt + p["dt_bias"])                       # (L, nh)
    decay = torch.exp(dt * -torch.exp(p["a_log"]))           # (L, nh)
    h = torch.zeros((nh, hd, ds), dtype=F32, device=hh.device)
    ys = []
    for t in range(n):
        h = decay[t][:, None, None] * h \
            + (dt[t][:, None] * x[t])[:, :, None] * b[t]
        ys.append(h @ c[t])
    y = (torch.stack(ys) + x * p["d_skip"][:, None]).reshape(n, di)
    y = rms_norm(y * F.silu(z), p["gate_norm"], a.norm_eps)
    return y @ p["out_proj"].to(F32)


def attention(hh, p, lin, a: Arch):
    """Causal GQA self-attention over one sequence's normed rows (L, d):
    the output projection's rows."""
    n = hh.shape[0]
    h, kv, hd = a.n_heads, a.n_kv_heads, a.hd
    q = lin["wq"](hh).reshape(n, h, hd)
    k = lin["wk"](hh).reshape(n, kv, hd)
    v = lin["wv"](hh).reshape(n, kv, hd)
    if a.use_rope:
        q, k = rope(q, a.rope_theta), rope(k, a.rope_theta)
    scale = (a.attention_multiplier if a.attention_multiplier is not None
             else 1.0 / math.sqrt(hd))
    k = k.repeat_interleave(h // kv, dim=1)
    v = v.repeat_interleave(h // kv, dim=1)
    pos = torch.arange(n, device=hh.device)
    outs = []
    for q0 in range(0, n, Q_BLOCK):
        s = torch.einsum("qhd,khd->hqk", q[q0:q0 + Q_BLOCK], k) * scale
        mask = pos[q0:q0 + Q_BLOCK, None] >= pos[None, :]
        s = torch.where(mask[None], s, -math.inf)
        outs.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v))
    return lin["wo"](torch.cat(outs).reshape(n, h * hd))


def route(hh, router, top_k: int):
    """Each row's (softmaxed top-k weights, expert ids), ties to the lower
    index."""
    vals, ids = torch.sort(hh @ router.to(F32), dim=-1, descending=True,
                           stable=True)
    return torch.softmax(vals[:, :top_k], dim=-1), ids[:, :top_k]


def routed(hh, p, a: Arch, n_prompt: int):
    """The routed experts' weighted sum over one sequence's normed rows:
    the first ``n_prompt`` rows route together under the expert capacity
    (an expert keeps the first ``capacity`` that chose it, and the
    prompt's last row also when it overflows), every later row alone."""
    w, ids = route(hh, p["router"], a.top_k)
    cap = a.expert_capacity(n_prompt)
    out = torch.zeros_like(hh)
    f = act(a.activation)
    for e in range(a.n_experts):
        hit = ids == e
        tok = hit.any(-1)
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
    return out


def shared(hh, lin, a: Arch):
    """The shared expert: a gated MLP of ``shared_d_ff`` on every row."""
    return lin["w_out"](act(a.activation)(lin["w_in"](hh))
                        * lin["w_gate"](hh))


def moe_with_shared(hh, p, lin, a: Arch, n_prompt: int):
    """What the MoE sublayer adds before the residual multiplier: the
    routed experts plus the shared expert."""
    return routed(hh, p, a, n_prompt) + shared(hh, lin, a)


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


def _served_logits(params, a: Arch, seqs, bits, wide):
    rm = a.residual_multiplier
    xs = [params["embed"][t].to(F32) * a.embedding_multiplier
          for t, _ in seqs]
    for layer in range(a.n_super):
        for i, kind in enumerate(a.pattern):
            p = _layer(params, i, layer)
            names = SHARED_LINEARS + (ATTN_LINEARS if kind in ATTN_KINDS
                                      else ())
            lin = {name: Linear(p[name], bits, wide) for name in names}
            for j, (x, (_, n_prompt)) in enumerate(zip(xs, seqs)):
                if kind in ATTN_KINDS:
                    x = x + rm * attention(rms_norm(x, p["norm1"],
                                                    a.norm_eps), p, lin, a)
                else:
                    x = x + rm * mamba2(rms_norm(x, p["norm_m"],
                                                 a.norm_eps), p, a)
                hh = rms_norm(x, p["norm_moe"], a.norm_eps)
                xs[j] = x + rm * moe_with_shared(hh, p, lin, a, n_prompt)
            del lin
    table = params["embed"] if a.tie_embeddings else params["lm_head"]
    out = []
    for x, (_, n_prompt) in zip(xs, seqs):
        h = rms_norm(x[n_prompt - 1:], params["final_norm"], a.norm_eps)
        logits = torch.cat([h @ table[v0:v0 + VOCAB_BLOCK].to(F32).T
                            for v0 in range(0, table.shape[0],
                                            VOCAB_BLOCK)], dim=-1)
        out.append(logits / a.logits_scaling)
    return out


# --------------------------------------------------------------------------
# model arithmetic
# --------------------------------------------------------------------------

def _block_params(kind: str, a: Arch) -> Tuple[int, int]:
    """(parameters of one block, of them its routed experts')."""
    n = sum(math.prod(shape)
            for shape, *_ in block_leaves(kind, a, F32).values())
    experts = 3 * a.n_experts * a.d_model * a.expert_width
    return n, experts


def param_count(a: Arch) -> int:
    emb = (1 if a.tie_embeddings else 2) * a.padded_vocab * a.d_model
    return emb + a.d_model + a.n_super * sum(_block_params(k, a)[0]
                                             for k in a.pattern)


def active_params(a: Arch) -> int:
    """Parameters a token reads: all but the embeddings and the routed
    experts it is not sent to (the shared expert is read by every
    token)."""
    total = 0
    for k in a.pattern:
        n, e = _block_params(k, a)
        total += n - e + e * a.top_k // a.n_experts
    return a.d_model + a.n_super * total


def recurrence_flops(a: Arch, tokens: int) -> float:
    """The Mamba-2 recurrence per token: the decay, ``dt x B^T``, the add
    and ``h C`` (two) over every state element, 5 a layer."""
    per = sum(5 * a.mamba_n_heads * a.mamba_d_head * a.mamba_d_state
              for k in a.pattern if k in MAMBA2_KINDS)
    return float(per * a.n_super * tokens)


def model_flops(a: Arch, tokens: int) -> float:
    """2 N_active per token processed (prompt or generated), plus the
    recurrences'."""
    return 2.0 * active_params(a) * tokens + recurrence_flops(a, tokens)


def step_linears(a: Arch) -> List[Tuple[int, int]]:
    """(K, N) of every projection one token row passes through the
    program's linear layer, layer after layer: the attention's four
    projections and the shared expert's three (the routed experts and
    Mamba-2's projections are plain products)."""
    d, h, kv, hd, sf = a.d_model, a.n_heads, a.n_kv_heads, a.hd, \
        a.shared_d_ff
    attn = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d)]
    shared_mlp = [(d, sf), (d, sf), (sf, d)]
    per = {k: (attn if k in ATTN_KINDS else []) + shared_mlp
           for k in a.pattern}
    return [s for k in a.pattern for s in per[k]] * a.n_super
