"""The parameter tree the benchmark draws from ``--seed`` and hands, the same
tensors, to the program and to the plain reference.

The tree is laid out as the program takes it: ``{"embed", "final_norm",
"lm_head", "blocks": {"<i>": {name: (n_super, ...)}}}``, block ``i`` being
position ``i`` of the layer pattern with its weights stacked over the
periods.  Random leaves are drawn on the target device, straight into the
type they are served in, each by one ``normal_`` call from one
``torch.Generator`` seeded from the seed; a normal leaf has standard
deviation ``scale / sqrt(fan_in)``, ``fan_in`` being its second-to-last
size."""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from bench.reference.arch import Arch

F32 = torch.float32

ATTN_KINDS = ("ad", "ae")
MLP_KINDS = ("ad", "md")
MOE_KINDS = ("ae", "me")
MAMBA_KINDS = ("md", "me")
KINDS = ("ad", "ae", "md", "me")

Leaf = Tuple[Tuple[int, ...], torch.dtype, str, float]


def _attn(a: Arch, dt) -> Dict[str, Leaf]:
    d, h, kv, hd = a.d_model, a.n_heads, a.n_kv_heads, a.hd
    out = {"norm1": ((d,), F32, "ones", 1.0),
           "wq": ((d, h * hd), dt, "normal", 1.0),
           "wk": ((d, kv * hd), dt, "normal", 1.0),
           "wv": ((d, kv * hd), dt, "normal", 1.0),
           "wo": ((h * hd, d), dt, "normal", 1.0)}
    if a.qkv_bias:
        out.update(bq=((h * hd,), F32, "zeros", 1.0),
                   bk=((kv * hd,), F32, "zeros", 1.0),
                   bv=((kv * hd,), F32, "zeros", 1.0))
    return out


def _mlp(a: Arch, dt) -> Dict[str, Leaf]:
    d, ff = a.d_model, a.d_ff
    out = {"norm2": ((d,), F32, "ones", 1.0),
           "w_in": ((d, ff), dt, "normal", 1.0),
           "w_out": ((ff, d), dt, "normal", 1.0)}
    if a.gated_mlp:
        out["w_gate"] = ((d, ff), dt, "normal", 1.0)
    return out


def _moe(a: Arch, dt) -> Dict[str, Leaf]:
    d, e, f = a.d_model, a.n_experts, a.expert_width
    return {"norm_moe": ((d,), F32, "ones", 1.0),
            "router": ((d, e), F32, "normal", 1.0),
            "w1": ((e, d, f), dt, "normal", 1.0),
            "w2": ((e, f, d), dt, "normal", 1.0),
            "w3": ((e, d, f), dt, "normal", 1.0)}


def _mamba(a: Arch, dt) -> Dict[str, Leaf]:
    d, di, ds, dc, r = (a.d_model, a.d_inner, a.mamba_d_state,
                        a.mamba_d_conv, a.dt_rank)
    return {"norm_m": ((d,), F32, "ones", 1.0),
            "in_proj": ((d, 2 * di), dt, "normal", 1.0),
            "conv_w": ((dc, di), F32, "normal", 0.5),
            "conv_b": ((di,), F32, "zeros", 1.0),
            "x_proj": ((di, r + 2 * ds), dt, "normal", 1.0),
            "dt_proj": ((r, di), F32, "normal", 0.5),
            "dt_bias": ((di,), F32, "zeros", 1.0),
            "a_log": ((di, ds), F32, "alog", 1.0),
            "d_skip": ((di,), F32, "ones", 1.0),
            "out_proj": ((di, d), dt, "normal", 1.0)}


def block_leaves(kind: str, a: Arch, dt) -> Dict[str, Leaf]:
    if kind not in KINDS:
        raise NotImplementedError(f"the benchmark draws no {kind!r} block")
    out: Dict[str, Leaf] = {}
    if kind in ATTN_KINDS:
        out.update(_attn(a, dt))
    if kind in MAMBA_KINDS:
        out.update(_mamba(a, dt))
    if kind in MLP_KINDS:
        out.update(_mlp(a, dt))
    if kind in MOE_KINDS:
        out.update(_moe(a, dt))
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


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(
        [seed % (1 << 63), 0x5EED]).generate_state(1, np.uint64)[0]
        % (1 << 63)))
    return g


def draw(a: Arch, seed: int, device) -> Dict:
    """The parameter tree of ``a`` drawn from ``seed`` on ``device``."""
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
