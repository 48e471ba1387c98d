"""Model assembly: parameter specs, prefill, decode and the train mode of
the dense ``"ad"`` stack, the MoE blocks ``"ae"`` and ``"ar"``, the Mamba
blocks ``"md"`` and ``"me"``, the xLSTM blocks ``"xm"`` and ``"xs"``, the
cross-attention block ``"adx"``, the encoder block ``"enc"``, and
granite-4.0-h's Mamba-2 and attention blocks with a shared expert
(``"ms"``, ``"as"``).

Parameters keep the reference's tree: ``{"embed", "final_norm", "blocks":
{"0": {name: (n_super, ...)}}}`` with every block weight stacked over the
layers, and the layers run as a Python loop over those stacks.  Caches keep
the reference's layout too: ``{"0": {"k": (n_super, B, cap, hkv, hd),
...}}`` for the contiguous pool, ``(n_super, num_blocks, block, hkv, hd)``
for the block-paged one.

Decode updates the caches **in place** and returns the same tree (the
reference, being functional, returns new arrays): a decode step writes one
row per slot, and copying the pool every step would cost its whole size.

Prefill runs its ``pim_sim`` linears on transient crossbar state
(``pim.engine.transient``): a prompt's length is a one-off GEMM shape, so
only the decode step keeps crossbar state resident.  So does
:func:`loss_fn`, the train mode: a train step changes its weights in place
every step, so no crossbar state of it could be used again.

With ``cfg.remat`` every super-block of the train mode runs under
``torch.utils.checkpoint`` (non-reentrant) and is recomputed during
``backward()``; the recompute re-enters the forward's lowering context
(``pim.engine.capture_context``), since it runs after ``loss_fn`` has
returned and, for CUDA tensors, on autograd's device thread.  Each token
chunk of the loss is checkpointed too, so no chunk's logits are kept.

A multi-position decode step (:func:`decode_run_slots`, the speculative
verify) runs every linear once over all ``B * S`` rows, and its other
float ops — the norms, attention and the unembed — one position at a
time, at the shapes of the single-position step: a reduction over more
rows may take another order on the card, and the verify must give the
bits of plain decode.

Sliding-window attention (``cfg.sliding_window``) keeps a ring of the
last window's keys: prefill lays the ring out by position (position ``p``
at index ``p % cap``), decode writes at ``pos % cap``, and the paged read
masks the ring through :func:`ring_slot_positions`, the helper the pool's
admit layout shares.  A multi-position decode step refuses windows: the
run's writes would destroy ring rows a rejected draft rolls back to.

The MoE blocks run self-attention, then :func:`moe.moe_ffn` on the
normed residual (``"ar"`` adds arctic's dense MLP on the same input).  The
experts are plain products in the compute dtype, outside ``linear``, as
in the reference; the router is a float32 product.  A multi-position
decode step routes all its ``B * S`` rows together, as the reference
does, so the capacity counts them all.

The recurrent blocks keep per-slot state in the caches instead of KV:
Mamba (``"md"``, ``"me"``: :func:`ssm.mamba_mixer`, then the dense MLP or
the MoE) holds ``ssm`` (float32) and ``conv``, xLSTM (``"xm"``, ``"xs"``:
:mod:`xlstm`) ``c``, ``n`` and ``m`` (float32).  Their projections are
plain products in the compute dtype, outside ``linear``, as in the
reference.  Decode writes the new state back into the pool's leaves in
place for every slot; an inactive slot computes on stale state, as in the
reference, and the next admit overwrites it.  Their state folds the whole
prefix, so the scheduler serves them unpadded (``prompt_bucket=1``) and
without prefix sharing, chunks, packs or speculation.

The cross-attention block ``"adx"`` (self-attention, cross-attention
onto a memory, the dense MLP) serves the encoder-decoder and vision
configs.  The memory is the encoder's output over the request's frames
(``"enc"`` blocks: non-causal self-attention without RoPE and the dense
MLP, run in train mode, then ``enc_norm``) or the patches projected by
``vision_proj``, a plain product in the compute dtype as in the
reference.  Prefill runs ``xwk``/``xwv`` on the memory and returns their
outputs as the ``xk``/``xv`` cache leaves, slot-indexed and not paged;
decode reads them and never writes them, so a decode step needs no
memory.  The encoder runs inside prefill's and ``loss_fn``'s transient
context like every other linear of theirs.

granite-4.0-h's blocks run the Mamba-2 mixer (``"ms"``:
:func:`ssm.mamba2_mixer`, state ``ssm`` and ``conv`` like Mamba's) or
self-attention (``"as"``), then the MoE with a shared expert beside it: a
gated MLP of ``shared_d_ff`` (``w_in``, ``w_gate``, ``w_out``) through
``linear`` on the same normed input, added to the routed experts' output
as arctic's dense residual is.  Its muP multipliers are fields of the
config: the embedding is scaled by ``embedding_multiplier``, each
sublayer's output by ``residual_multiplier`` before its residual add, the
attention scores by ``attention_multiplier`` (instead of ``1 /
sqrt(hd)``), and the logits divided by ``logits_scaling``; ``use_rope``
False drops RoPE (NoPE).  At their defaults none of them adds an
operation.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.zero import Gathered
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Spec, activation, apply_rope,
                                       embed_lookup, linear, materialize,
                                       rms_norm, unembed)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import mamba2_mixer, mamba_mixer
from repro_torch.models.xlstm import mlstm_block, slstm_block
from repro_torch.runtime.trace import span
from repro_torch.tree import leaves as _leaves

Params = Dict[str, Any]

#: Attention-KV leaf names eligible for block paging.
PAGED_KV_KEYS = ("k", "v", "k_scale", "v_scale")

#: Block kinds the port runs: dense, MoE, MoE with a dense residual,
#: dense with cross-attention, the encoder's, Mamba with a dense MLP or the
#: MoE, mLSTM and sLSTM, Mamba-2 and attention with a shared expert.
PORTED_KINDS = ("ad", "ae", "ar", "adx", "enc", "md", "me", "xm", "xs",
                "ms", "as")

#: Kinds with self-attention (``"enc"`` only in the encoder stack, so never
#: with a KV cache), with the dense MLP, with the MoE, and with a shared
#: expert beside it.
_ATTN_KINDS = ("ad", "ae", "ar", "adx", "enc", "as")
_MLP_KINDS = ("ad", "adx", "enc", "md", "ar")
_MOE_KINDS = ("ae", "ar", "me", "ms", "as")
_SHARED_KINDS = ("ms", "as")
_MAMBA_KINDS = ("md", "me", "ms")
_XLSTM_KINDS = ("xm", "xs")
#: Cross-attention cache leaves: written by prefill, read by decode.
_XATTN_KEYS = ("xk", "xv")


def _check_supported(cfg: ModelConfig) -> None:
    bad = [k for k in cfg.pattern if k not in PORTED_KINDS]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not ported; the port runs "
            f"{'/'.join(PORTED_KINDS)}")


def _refuse_window_run(cfg: ModelConfig) -> None:
    if cfg.sliding_window:
        raise ValueError("multi-position decode (speculative verify) does "
                         "not support sliding_window")


def ring_slot_positions(last_pos, r, ring: int, window: int):
    """Sliding-window ring congruence, shared by writeback and readback.

    For ring index ``r`` (broadcastable against ``last_pos``), returns
    ``(p_r, valid)``: the newest absolute position ``<= last_pos`` with
    ``p_r % ring == r``, and whether that position exists and is still
    inside the attention window.  The paged decode path (reading a slot's
    block ring at position ``last_pos``) and the pool's admit layout
    (laying out a ``plen``-token prefill, ``last_pos = plen - 1``) must
    agree on this bit for bit — keep both on this helper."""
    p_r = last_pos - ((last_pos - r) % ring)
    return p_r, (p_r >= 0) & (p_r > last_pos - window)


# ==========================================================================
# parameter specs
# ==========================================================================

def _spec(shape, dt, init: str = "normal", scale: float = 1.0) -> Spec:
    return Spec(tuple(shape), dt, init, scale)


def _attn_specs(cfg: ModelConfig, dt) -> Dict[str, Spec]:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    f32 = torch.float32
    s = {
        "norm1": _spec((d,), f32, "ones"),
        "wq": _spec((d, h * hd), dt),
        "wk": _spec((d, hkv * hd), dt),
        "wv": _spec((d, hkv * hd), dt),
        "wo": _spec((h * hd, d), dt),
    }
    if cfg.qkv_bias:
        s.update(bq=_spec((h * hd,), f32, "zeros"),
                 bk=_spec((hkv * hd,), f32, "zeros"),
                 bv=_spec((hkv * hd,), f32, "zeros"))
    return s


def _mlp_specs(cfg: ModelConfig, dt) -> Dict[str, Spec]:
    d, ff = cfg.d_model, cfg.d_ff
    s = {"norm2": _spec((d,), torch.float32, "ones"),
         "w_in": _spec((d, ff), dt),
         "w_out": _spec((ff, d), dt)}
    if cfg.gated_mlp:
        s["w_gate"] = _spec((d, ff), dt)
    return s


def _moe_specs(cfg: ModelConfig, dt) -> Dict[str, Spec]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    return {"norm_moe": _spec((d,), torch.float32, "ones"),
            "router": _spec((d, e), torch.float32),
            "w1": _spec((e, d, f), dt),
            "w2": _spec((e, f, d), dt),
            "w3": _spec((e, d, f), dt)}


def _xattn_specs(cfg: ModelConfig, dt) -> Dict[str, Spec]:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"normx": _spec((d,), torch.float32, "ones"),
            "xwq": _spec((d, h * hd), dt),
            "xwk": _spec((d, hkv * hd), dt),
            "xwv": _spec((d, hkv * hd), dt),
            "xwo": _spec((h * hd, d), dt)}


def _mamba_specs(cfg: ModelConfig, dt) -> Dict[str, Spec]:
    d, di, ds, dc, dtr = (cfg.d_model, cfg.d_inner, cfg.mamba_d_state,
                          cfg.mamba_d_conv, cfg.dt_rank)
    f32 = torch.float32
    return {"norm_m": _spec((d,), f32, "ones"),
            "in_proj": _spec((d, 2 * di), dt),
            "conv_w": _spec((dc, di), f32, "normal", 0.5),
            "conv_b": _spec((di,), f32, "zeros"),
            "x_proj": _spec((di, dtr + 2 * ds), dt),
            "dt_proj": _spec((dtr, di), f32, "normal", 0.5),
            "dt_bias": _spec((di,), f32, "zeros"),
            "a_log": _spec((di, ds), f32, "alog"),
            "d_skip": _spec((di,), f32, "ones"),
            "out_proj": _spec((di, d), dt)}


def _shared_specs(cfg: ModelConfig, dt) -> Dict[str, Spec]:
    d, f = cfg.d_model, cfg.shared_d_ff
    return {"w_in": _spec((d, f), dt),
            "w_gate": _spec((d, f), dt),
            "w_out": _spec((f, d), dt)}


def _mamba2_specs(cfg: ModelConfig, dt) -> Dict[str, Spec]:
    d, di, ds, dc, nh = (cfg.d_model, cfg.d_inner, cfg.mamba_d_state,
                         cfg.mamba_d_conv, cfg.mamba_n_heads)
    if di % nh:
        raise ValueError(f"{cfg.name}: d_inner {di} is not {nh} Mamba-2 "
                         f"heads of one width")
    f32 = torch.float32
    return {"norm_m": _spec((d,), f32, "ones"),
            "in_proj": _spec((d, 2 * di + 2 * ds + nh), dt),
            "conv_w": _spec((dc, di + 2 * ds), f32, "normal", 0.5),
            "conv_b": _spec((di + 2 * ds,), f32, "zeros"),
            "dt_bias": _spec((nh,), f32, "zeros"),
            "a_log": _spec((nh,), f32, "alog"),
            "d_skip": _spec((nh,), f32, "ones"),
            "gate_norm": _spec((di,), f32, "ones"),
            "out_proj": _spec((di, d), dt)}


def _xlstm_inner(cfg: ModelConfig) -> Tuple[int, int]:
    """(p, dh): the xLSTM blocks' inner width and head width."""
    p = int(cfg.xlstm_proj_factor * cfg.d_model)
    p -= p % cfg.n_heads
    return p, p // cfg.n_heads


def _mlstm_specs(cfg: ModelConfig, dt) -> Dict[str, Spec]:
    d, nh = cfg.d_model, cfg.n_heads
    p, dh = _xlstm_inner(cfg)
    return {"norm_x": _spec((d,), torch.float32, "ones"),
            "up_proj": _spec((d, 2 * p), dt),
            # block-diagonal per-head projections
            "wq": _spec((nh, dh, dh), dt),
            "wk": _spec((nh, dh, dh), dt),
            "wv": _spec((nh, dh, dh), dt),
            "w_gates": _spec((p, 2 * nh), torch.float32, "normal", 0.5),
            "down_proj": _spec((p, d), dt)}


def _slstm_specs(cfg: ModelConfig, dt) -> Dict[str, Spec]:
    d, nh = cfg.d_model, cfg.n_heads
    p, dh = _xlstm_inner(cfg)
    return {"norm_x": _spec((d,), torch.float32, "ones"),
            "up_proj": _spec((d, 2 * p), dt),
            "wz": _spec((nh, dh, dh), dt),
            "w_gates": _spec((p, 3 * nh), torch.float32, "normal", 0.5),
            "down_proj": _spec((p, d), dt)}


def _block_specs(kind: str, cfg: ModelConfig, dt) -> Dict[str, Spec]:
    s: Dict[str, Spec] = {}
    if kind in _ATTN_KINDS:
        s.update(_attn_specs(cfg, dt))
    if kind in _MLP_KINDS:
        s.update(_mlp_specs(cfg, dt))
    if kind in _MOE_KINDS:
        s.update(_moe_specs(cfg, dt))
    if kind in _SHARED_KINDS:
        s.update(_shared_specs(cfg, dt))
    if kind == "adx":
        s.update(_xattn_specs(cfg, dt))
    if kind == "ms":
        s.update(_mamba2_specs(cfg, dt))
    elif kind in _MAMBA_KINDS:
        s.update(_mamba_specs(cfg, dt))
    if kind == "xm":
        s.update(_mlstm_specs(cfg, dt))
    if kind == "xs":
        s.update(_slstm_specs(cfg, dt))
    return s


def _stack_specs(specs: Dict[str, Spec], n: int) -> Dict[str, Spec]:
    """Each block spec with a leading layer dim of ``n``."""
    return {k: Spec((n,) + tuple(v.shape), v.dtype, v.init, v.scale)
            for k, v in specs.items()}


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter tree as :class:`layers.Spec` leaves (shape, dtype,
    init kind, scale), the reference's tree leaf for leaf."""
    _check_supported(cfg)
    dt = cfg.compute_dtype
    v, d = cfg.padded_vocab, cfg.d_model
    out: Params = {
        "embed": _spec((v, d), dt),
        "final_norm": _spec((d,), torch.float32, "ones"),
        "blocks": {str(i): _stack_specs(_block_specs(kind, cfg, dt),
                                        cfg.n_super)
                   for i, kind in enumerate(cfg.pattern)},
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = _spec((v, d), dt)
    if cfg.is_encoder_decoder:
        out["encoder"] = {
            "blocks": {"0": _stack_specs(_block_specs("enc", cfg, dt),
                                         cfg.n_encoder_layers)},
            "enc_norm": _spec((d,), torch.float32, "ones"),
        }
    if cfg.vision_dim:
        out["vision_proj"] = _spec((cfg.vision_dim, d), dt)
    return out


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def draw_leaves(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """``(path, leaf)`` of every parameter, drawn one after another on
    ``device`` as :func:`init_params` draws them, in sorted-path order: a
    caller that keeps only a shard of each leaf (the sharded trainer)
    holds one whole leaf at a time."""
    from repro_torch.models.layers import draw_specs

    return draw_specs(param_specs(cfg), seed, device)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters drawn on ``device``: ``layers.materialize`` of
    :func:`param_specs` (the reference's init rule: normal leaves draw std
    ``scale/sqrt(fan_in)``, ``"alog"`` leaves hold ``log(1..d_state)``).

    Random leaf ``i``, in sorted-path order, is drawn by ``normal_``
    straight into its dtype on ``device`` from its own generator: no host
    array and no float32 temporary is made, so the draw needs only the
    model's own bytes.  The draw is deterministic for a given seed and
    device type (on a card, for a given card model), but the CPU and CUDA
    generators differ: one seed gives other weights on the CPU than on a
    card.  Parity with the reference goes through :func:`from_reference`,
    not through this draw."""
    return materialize(param_specs(cfg), seed, device)


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")    # writable, contiguous
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_reference(params_np, cfg: ModelConfig, device="cuda") -> Params:
    """The port's parameters from the reference's ``init_params`` tree
    (leaves as numpy arrays, block weights stacked per layer), bit for
    bit, on ``device``."""
    dev = resolve_device(device)
    out: Params = {}
    for path, (shape, dt, _, _) in _leaves(param_specs(cfg)):
        node = params_np
        for k in path:
            node = node[k]
        t = _from_numpy(np.asarray(node))
        if tuple(t.shape) != tuple(shape) or t.dtype != dt:
            raise ValueError(f"reference leaf {'/'.join(path)} is "
                             f"{tuple(t.shape)} {t.dtype}, expected "
                             f"{shape} {dt}")
        _set(out, path, t.to(dev))
    return out


# ==========================================================================
# block application
# ==========================================================================

def _quantize_kv(x):
    """(B, S, H, D) -> (int8 values, f32 per-(B,S,H) scales)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127
                    ).to(torch.int8)
    return q, scale


def _dequantize_kv(q, scale, dtype):
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def _kv_leaves(k, v, quant: bool):
    if quant:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


def _read_kv(c, cfg: ModelConfig, quant: bool):
    if quant:
        return (_dequantize_kv(c["k"], c["k_scale"], cfg.compute_dtype),
                _dequantize_kv(c["v"], c["v_scale"], cfg.compute_dtype))
    return c["k"], c["v"]


def _per_position(fn, x, *rest):
    """``fn`` applied to each position ``x[:, i:i+1]`` (and the matching
    slice of each of ``rest``) on its own, the results concatenated on dim
    1: every call has the shapes of a single-position decode step."""
    return torch.cat([fn(x[:, i:i + 1].contiguous(),
                         *(r[:, i:i + 1] for r in rest))
                      for i in range(x.shape[1])], dim=1)


def _norm(x, weight, cfg: ModelConfig, run: bool):
    if run:
        return _per_position(lambda xi: rms_norm(xi, weight, cfg.norm_eps), x)
    return rms_norm(x, weight, cfg.norm_eps)


def _self_attention(x, p, cfg: ModelConfig, positions, mode, cache, pos,
                    causal=True, block_tables=None, segment_ids=None):
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    quant = cfg.kv_cache_dtype == "int8"
    # a multi-position decode step: the speculative verify run
    run = mode == "decode" and s > 1
    hh = _norm(x, p["norm1"], cfg, run)
    q = linear(hh, p["wq"], p.get("bq")).reshape(b, s, h, hd)
    k = linear(hh, p["wk"], p.get("bk")).reshape(b, s, hkv, hd)
    v = linear(hh, p["wv"], p.get("bv")).reshape(b, s, hkv, hd)
    if causal and cfg.use_rope:  # RoPE only on the causal (decoder) stacks
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    scale = cfg.attention_multiplier
    new_cache = None
    if mode == "decode" and block_tables is not None:
        # Block-paged cache: leaves are (num_blocks, block, ...) physical
        # stores shared by every slot; ``block_tables`` (B, blocks_per_slot)
        # maps each slot's logical blocks to physical ones (sentinel
        # entries point at the reserved trash block 0, which no reader
        # unmasks).  Token i of the step is written at logical row
        # pos + i, and query i sees the rows up to its own.  A write at or
        # past the slot's logical capacity lcap is routed to the trash
        # block: the clamped table gather would otherwise resolve to the
        # slot's *last real block* and overwrite a committed row.
        # Under a sliding window the logical row is the position modulo
        # the block-rounded ring, and the mask keeps the ring rows whose
        # newest position is inside the window.
        bs_blk = cache["k"].shape[1]
        lcap = block_tables.shape[1] * bs_blk
        r = torch.arange(lcap, device=x.device)
        bidx = torch.arange(b, device=x.device)[:, None]
        if cfg.sliding_window:
            if s > 1:
                _refuse_window_run(cfg)
            ring = cfg.window_ring_blocks(bs_blk) * bs_blk
            widx = (pos % ring)[:, None]                         # (B, 1)
            _, in_ring = ring_slot_positions(pos[:, None], r[None, :], ring,
                                             cfg.sliding_window)
            valid = ((r[None, :] < ring) & in_ring)[:, None]     # (B, 1, lcap)
            blk = block_tables[bidx, widx // bs_blk]
        else:
            widx = pos[:, None] + torch.arange(s, device=x.device)  # (B, s)
            valid = r[None, None, :] <= widx[:, :, None]       # (B, s, lcap)
            blk = block_tables[bidx,
                               torch.clamp(widx, max=lcap - 1) // bs_blk]
            blk = torch.where(widx < lcap, blk, torch.zeros_like(blk))
        off = widx % bs_blk
        for key, new in _kv_leaves(k, v, quant).items():
            cache[key][blk, off] = new.to(cache[key].dtype)
        gathered = {key: c[block_tables].reshape((b, lcap) + c.shape[2:])
                    for key, c in cache.items()}
        k_full, v_full = _read_kv(gathered, cfg, quant)
        out = _decode_attention(q, k_full, v_full, valid, scale)
        new_cache = cache
    elif mode == "decode":
        cap = cache["k"].shape[1]
        leaves = _kv_leaves(k, v, quant)
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            # continuous batching: each slot writes token i at its own
            # absolute position pos + i; a write at or past the capacity
            # is dropped (it keeps the row's old value) rather than
            # wrapped onto live row 0 — but a sliding window's ring wraps
            # (pos % cap).  One position at a time, so that no two writes
            # of one call land on the same row.
            if s > 1:
                _refuse_window_run(cfg)
            bidx = torch.arange(b, device=x.device)
            for i in range(s):
                at = pos + i
                keep = (at < cap) | bool(cfg.sliding_window)
                idx = at % cap if cfg.sliding_window \
                    else torch.clamp(at, max=cap - 1)
                for key, new in leaves.items():
                    c = cache[key]
                    new = new[:, i].to(c.dtype)
                    kshape = (b,) + (1,) * (new.dim() - 1)
                    c[bidx, idx] = torch.where(keep.reshape(kshape), new,
                                               c[bidx, idx])
            # row r is live up to the query's position (a full ring, past
            # the first wrap, is live entirely)
            widx = pos[:, None] + torch.arange(s, device=x.device)
            valid = (torch.arange(cap, device=x.device)[None, None, :]
                     <= widx[:, :, None])                        # (B, s, cap)
        elif s > 1:
            raise ValueError("multi-position decode needs per-slot (B,) "
                             "positions")
        else:
            idx = int(pos) % cap
            for key, new in leaves.items():
                cache[key][:, idx:idx + s] = new.to(cache[key].dtype)
            valid = None
            cache_len = min(int(pos) + 1, cap)
        k_full, v_full = _read_kv(cache, cfg, quant)
        if valid is None:
            out = attn.decode_attention(q, k_full, v_full, cache_len,
                                        scale=scale)
        else:
            out = _decode_attention(q, k_full, v_full, valid, scale)
        new_cache = cache
    else:
        window = cfg.sliding_window if causal else None
        attn_fn = attn.flash_attention if cfg.flash_attention \
            else attn.direct_attention
        if mode == "prefill" and cache is not None:
            # Prefix-resume prefill (prefix caching, chunked prefill):
            # ``cache`` holds the prompt prefix KV — dense, post-RoPE,
            # positions 0..m-1, gathered by ``PagedCachePool.read_prefix``
            # — and the caller shifted ``positions`` by m, so q/k here are
            # already rotated at absolute positions m..m+s-1.  Queries
            # attend concat(prefix, tail) with ``q_offset=m``; the emitted
            # cache is the *tail only*, unpadded — the paged pool scatters
            # it at block offset m without touching the prefix blocks.
            m_len = cache["k"].shape[1]
            pk, pv = _read_kv(cache, cfg, quant)
            out = attn_fn(q, torch.cat([pk.to(k.dtype), k], dim=1),
                          torch.cat([pv.to(v.dtype), v], dim=1),
                          causal=causal, window=window, q_offset=m_len,
                          scale=scale)
            new_cache = _tail_kv(k, v, cfg, quant)
        elif segment_ids is not None:
            # Packed prefill: several prompts share one (1, L) stream.
            # ``positions`` restarts at 0 per segment (it already drove
            # RoPE above) and the segment mask keeps attention
            # block-diagonal.  The emitted cache is the raw packed k/v;
            # ``PagedCachePool.admit(start=)`` unpacks each segment (a
            # windowed segment packs only while it fits the window, where
            # the ring layout is the dense one).
            out = attn_fn(q, k, v, causal=causal, window=window,
                          segment_ids=segment_ids, positions=positions,
                          scale=scale)
            new_cache = _tail_kv(k, v, cfg, quant)
        else:
            out = attn_fn(q, k, v, causal=causal, window=window,
                          scale=scale)
        if mode == "prefill" and new_cache is None:
            if window:
                # the ring: the window, with decode headroom padded for a
                # prompt shorter than it, capped at max_seq_len like the
                # dense cache; a longer prompt keeps its last cap
                # positions, position p at index p % cap (where decode
                # writes it)
                cap = min(window, max(s, cfg.max_seq_len))
                if s < cap:
                    kc, vc = k, v
                else:
                    shift = (s - cap) % cap
                    kc = torch.roll(k[:, -cap:], shift, dims=1)
                    vc = torch.roll(v[:, -cap:], shift, dims=1)
            else:
                # full cache with decode headroom up to max_seq_len
                cap = max(s, cfg.max_seq_len)
                kc, vc = k, v
            if cap > kc.shape[1]:
                pad = (0, 0, 0, 0, 0, cap - kc.shape[1])
                kc = torch.nn.functional.pad(kc, pad)
                vc = torch.nn.functional.pad(vc, pad)
            if not quant:
                kc, vc = kc.to(cfg.compute_dtype), vc.to(cfg.compute_dtype)
            new_cache = _kv_leaves(kc, vc, quant)
    y = linear(out.reshape(b, s, h * hd), p["wo"])
    return x + _residual(y, cfg), new_cache


def _residual(y, cfg: ModelConfig):
    """A sublayer's output as its residual add takes it."""
    if cfg.residual_multiplier == 1.0:
        return y
    return y * cfg.residual_multiplier


def _decode_attention(q, k_full, v_full, valid, scale=None):
    """Decode attention of queries (B, s) under a per-query mask
    (B, s, S), one query position at a time (see the module docstring)."""
    return _per_position(
        lambda qi, vi: attn.decode_attention(qi, k_full, v_full,
                                             valid=vi[:, 0], scale=scale),
        q, valid)


def _tail_kv(k, v, cfg: ModelConfig, quant: bool):
    """The unpadded cache of a resumed or packed prefill."""
    if quant:
        return _kv_leaves(k, v, True)
    return _kv_leaves(k.to(cfg.compute_dtype), v.to(cfg.compute_dtype),
                      False)


def _cross_attention(x, p, cfg: ModelConfig, memory, mode, cache,
                     run: bool = False):
    """Cross-attention onto ``memory`` (B, S_m, d): prefill and train run
    ``xwk``/``xwv`` on it (prefill returns them, in the compute dtype, as
    the ``xk``/``xv`` leaves; train keeps nothing); decode reads them from
    ``cache`` and writes nothing."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    hh = _norm(x, p["normx"], cfg, run)
    q = linear(hh, p["xwq"]).reshape(b, s, h, hd)
    new_cache = None
    if mode == "decode":
        k, v = cache["xk"], cache["xv"]
    else:
        sk = memory.shape[1]
        k = linear(memory, p["xwk"]).reshape(b, sk, hkv, hd)
        v = linear(memory, p["xwv"]).reshape(b, sk, hkv, hd)
        if mode == "prefill":
            new_cache = {"xk": k.to(cfg.compute_dtype),
                         "xv": v.to(cfg.compute_dtype)}
    if run:
        out = _per_position(lambda qi: attn.cross_attention(qi, k, v), q)
    else:
        out = attn.cross_attention(q, k, v)
    y = linear(out.reshape(b, s, h * hd), p["xwo"])
    return x + y, new_cache


def _dense_ffn(hh, p, cfg: ModelConfig):
    act = activation(cfg.activation)
    h = act(linear(hh, p["w_in"]))
    if cfg.gated_mlp:
        h = h * linear(hh, p["w_gate"])
    return linear(h, p["w_out"])


def _mlp(x, p, cfg: ModelConfig, run: bool = False):
    hh = _norm(x, p["norm2"], cfg, run)
    return x + _dense_ffn(hh, p, cfg)


def _moe(x, p, cfg: ModelConfig, dense_residual: bool, run: bool = False):
    """The MoE block on the normed residual; all rows route together (a
    multi-position decode step's too, as in the reference)."""
    hh = _norm(x, p["norm_moe"], cfg, run)
    if not dense_residual:
        return x + _residual(moe_ffn(hh, p, cfg), cfg)
    # arctic's dense MLP, or a shared expert, beside it; launched first, so
    # that on the card its linears run while the host dispatches the experts
    with span("moe.shared"):
        dense = _dense_ffn(hh, p, cfg)
    return x + _residual(moe_ffn(hh, p, cfg) + dense, cfg)


def _recurrent_cache(mode, cache, state):
    """A recurrent block's cache out: its new ``state`` after prefill;
    after decode the pool's leaves, updated in place from it; None in
    train."""
    if mode == "decode":
        for key, t in state.items():
            cache[key].copy_(t.to(cache[key].dtype))
        return cache
    return state if mode == "prefill" else None


def _mamba(x, p, cfg: ModelConfig, mode, cache, kind):
    hh = rms_norm(x, p["norm_m"], cfg.norm_eps)
    state = (cache["ssm"], cache["conv"]) if mode == "decode" else None
    fn = mamba2_mixer if kind == "ms" else mamba_mixer
    y, (ssm, conv) = fn(hh, p, cfg, state)
    return x + _residual(y, cfg), _recurrent_cache(mode, cache, {
        "ssm": ssm.to(torch.float32), "conv": conv.to(cfg.compute_dtype)})


def _xlstm(x, p, cfg: ModelConfig, mode, cache, kind):
    hh = rms_norm(x, p["norm_x"], cfg.norm_eps)
    fn = mlstm_block if kind == "xm" else slstm_block
    state = ((cache["c"], cache["n"], cache["m"]) if mode == "decode"
             else None)
    y, (c, n, m) = fn(hh, p, cfg, state)
    return x + y, _recurrent_cache(mode, cache, {
        "c": c.to(torch.float32), "n": n.to(torch.float32),
        "m": m.to(torch.float32)})


def apply_block(kind: str, x, p, cfg: ModelConfig, *, positions, mode,
                cache=None, pos=None, memory=None, block_tables=None,
                segment_ids=None):
    """Returns (x, cache_out or None), in the reference's order: the
    mixer (self-attention, Mamba, Mamba-2 or xLSTM), the cross-attention
    of ``"adx"`` onto ``memory``, then the dense MLP (``"ad"``, ``"adx"``,
    ``"enc"``, ``"md"``) or the MoE (``"ae"``, ``"me"``; ``"ar"`` with
    arctic's dense residual, ``"ms"`` and ``"as"`` with a shared expert).
    ``"enc"`` attends without a causal mask or RoPE."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    # a multi-position decode step: the speculative verify run
    run = mode == "decode" and x.shape[1] > 1
    if kind in _ATTN_KINDS:
        # the self-attention sees its KV leaves only (a paged read gathers
        # every leaf it is given through the block table)
        kv = (None if cache is None else
              {k: v for k, v in cache.items() if k not in _XATTN_KEYS})
        x, c = _self_attention(x, p, cfg, positions, mode, kv, pos,
                               causal=kind != "enc",
                               block_tables=block_tables,
                               segment_ids=segment_ids)
        if kind == "adx":
            x, xc = _cross_attention(x, p, cfg, memory, mode, cache, run)
            if xc:
                c = {**c, **xc}
    elif kind in _MAMBA_KINDS:
        x, c = _mamba(x, p, cfg, mode, cache, kind)
    else:
        x, c = _xlstm(x, p, cfg, mode, cache, kind)
    if kind in _MOE_KINDS:
        x = _moe(x, p, cfg, dense_residual=kind in ("ar",) + _SHARED_KINDS,
                 run=run)
    elif kind in _MLP_KINDS:
        x = _mlp(x, p, cfg, run=run)
    return x, c


# ==========================================================================
# stacks
# ==========================================================================

def _decoder_stack(params, x, cfg: ModelConfig, *, positions, mode,
                   caches=None, pos=None, memory=None, block_tables=None,
                   segment_ids=None):
    """Loop over super-blocks.  ``caches``: {pattern index: stacked cache}
    (in prefill, the mapped prefix to resume from); ``memory``: what the
    ``"adx"`` blocks attend to in prefill and train.  Prefill returns
    freshly stacked caches; decode updates ``caches`` in place and returns
    it; train returns ``(x, None)``."""
    if mode == "train":
        return _train_stack(params, x, cfg, positions, memory), None
    per_layer = {str(i): [] for i in range(len(cfg.pattern))}
    for layer in range(cfg.n_super):
        for i, kind in enumerate(cfg.pattern):
            p = {k: v[layer] for k, v in params["blocks"][str(i)].items()}
            c = ({k: v[layer] for k, v in caches[str(i)].items()}
                 if caches is not None else None)
            x, cout = apply_block(kind, x, p, cfg, positions=positions,
                                  mode=mode, cache=c, pos=pos, memory=memory,
                                  block_tables=block_tables,
                                  segment_ids=segment_ids)
            per_layer[str(i)].append(cout)
    if mode == "decode":
        return x, caches
    if mode == "prefill":
        return x, {i: {k: torch.stack([c[k] for c in cs])
                       for k in cs[0]} for i, cs in per_layer.items()}
    return x, None


def _recompute_ctx():
    """``torch.utils.checkpoint``'s ``context_fn``: nothing around the
    forward, the forward's lowering context around the recompute."""
    from repro_torch.pim import engine

    return contextlib.nullcontext(), engine.capture_context()


def _unbound(stacks):
    """Per-layer views of stacked block weights, unbound once: unbind's
    backward stacks the per-layer gradients in one op, where indexing
    would build a zero-filled stack per layer.  A sharded tree's stacks
    (``dist.zero.Gathered``) unbind their shards themselves."""
    if isinstance(stacks, Gathered):
        return {i: stacks[i] for i in stacks}
    return {i: {k: v.unbind(0) for k, v in b.items()}
            for i, b in stacks.items()}


def _layer(stack, layer: int):
    """Layer ``layer``'s block weights: per-layer views, or a sharded
    stack's layer view, which gathers each weight where the block reads
    it."""
    if isinstance(stack, Gathered):
        return stack.layer(layer)
    return {k: v[layer] for k, v in stack.items()}


def _train_stack(params, x, cfg: ModelConfig, positions, memory=None):
    """The train mode's layer loop, each super-block checkpointed when
    ``cfg.remat`` (``memory`` passed in, so the recompute reads the same
    tensor)."""
    blocks = _unbound(params["blocks"])

    def body(x, layer, memory):
        for i, kind in enumerate(cfg.pattern):
            x, _ = apply_block(kind, x, _layer(blocks[str(i)], layer), cfg,
                               positions=positions, mode="train",
                               memory=memory)
        return x

    for layer in range(cfg.n_super):
        if cfg.remat:
            x = checkpoint(body, x, layer, memory, use_reentrant=False,
                           preserve_rng_state=False,
                           context_fn=_recompute_ctx)
        else:
            x = body(x, layer, memory)
    return x


def _encode(params, frames, cfg: ModelConfig):
    """The encoder over ``frames`` (B, S_f, d): ``"enc"`` blocks in train
    mode at positions ``arange(S_f)``, then ``enc_norm``.  No remat: the
    reference checkpoints the decoder stack only."""
    x = frames.to(cfg.compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    blocks = _unbound(params["encoder"]["blocks"])["0"]
    for layer in range(cfg.n_encoder_layers):
        x, _ = apply_block("enc", x, _layer(blocks, layer), cfg,
                           positions=positions, mode="train")
    return rms_norm(x, params["encoder"]["enc_norm"], cfg.norm_eps)


def _memory(params, batch, cfg: ModelConfig):
    """What the ``"adx"`` blocks attend to: the encoder's output over
    ``batch["frames"]``, or ``batch["patches"] @ vision_proj`` in the
    compute dtype (a plain product, outside ``linear``, as in the
    reference); None for a decoder-only config."""
    if cfg.is_encoder_decoder:
        return _encode(params, batch["frames"], cfg)
    if cfg.vision_dim:
        dt = cfg.compute_dtype
        return torch.matmul(batch["patches"].to(dt),
                            params["vision_proj"].to(dt))
    return None


# ==========================================================================
# entry points: loss / prefill / decode
# ==========================================================================

def _embed_in(params, tokens, cfg: ModelConfig):
    x = embed_lookup(params["embed"], tokens).to(cfg.compute_dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x


def _unembed_table(params, cfg):
    return params["lm_head"] if "lm_head" in params else params["embed"]


def _logits(x, table, cfg: ModelConfig, chunk=None):
    """float32 logits of the final-normed ``x``, over ``logits_scaling``."""
    logits = unembed(x, table, chunk=chunk).to(torch.float32)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def _pim_ctx(cfg: ModelConfig):
    """Thread ``cfg.pim_mode`` into every ``linear`` below the entry
    point; ``None`` defers to the caller's ambient ``pim.engine.mode``."""
    if cfg.pim_mode is None:
        return contextlib.nullcontext()
    from repro_torch.pim import engine

    return engine.mode(cfg.pim_mode)


@contextlib.contextmanager
def _transient_ctx(cfg: ModelConfig):
    """``_pim_ctx`` plus transient crossbar state for every ``pim_sim``
    linear (``pim.engine.transient``): a prefill's row count is a one-off
    shape, and a train step's weights change every step, so neither keeps
    its states resident."""
    from repro_torch.pim import engine

    with _pim_ctx(cfg), engine.transient():
        yield


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross entropy (chunked over tokens), in float32.

    ``batch``: ``{"tokens": (B, S) int, "labels": (B, S) int}``, with
    ``"frames"`` (B, S_f, d) for an encoder-decoder config or
    ``"patches"`` (B, n_patches, vision_dim) for a vision one.  The
    linears lower per ``cfg.pim_mode`` on transient crossbar state; with
    ``cfg.remat`` each super-block is recomputed in ``backward()``."""
    nll, n_tok = nll_sum(params, batch, cfg)
    return nll / n_tok


def nll_sum(params, batch, cfg: ModelConfig):
    """``(sum of the tokens' NLL, token count)`` of ``batch``: what
    :func:`loss_fn` divides.  ``params`` may be a sharded tree
    (``dist.zero.Gathered``), whose leaves are gathered where they are
    read; the sharded trainer (``launch.train``) adds the ranks' sums into
    the global mean."""
    _check_supported(cfg)
    with _transient_ctx(cfg):
        return _loss_fn(params, batch, cfg)


def _loss_fn(params, batch, cfg: ModelConfig):
    """(sum of the tokens' NLL, the token count) of ``batch``."""
    tokens = batch["tokens"]
    labels = batch["labels"]
    x = _embed_in(params, tokens, cfg)
    memory = _memory(params, batch, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, _ = _decoder_stack(params, x, cfg, positions=positions, mode="train",
                          memory=memory)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = _unembed_table(params, cfg)

    flat_x = x.reshape(-1, cfg.d_model)
    flat_y = labels.reshape(-1).long()
    n_tok = flat_x.shape[0]
    chunk = cfg.loss_chunk if n_tok % cfg.loss_chunk == 0 else n_tok

    def chunk_nll(xc, yc):
        logits = _logits(xc, table, cfg, chunk=cfg.unembed_chunk or None)
        m = logits.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[:, 0]
        # the gold logit: the one term of the reference's mask-sum
        gold = torch.gather(logits, 1, yc[:, None])[:, 0]
        return torch.sum(lse - gold)

    # checkpointed: no chunk's logits are kept for the backward
    nll = torch.stack([
        checkpoint(chunk_nll, flat_x[i:i + chunk], flat_y[i:i + chunk],
                   use_reentrant=False, preserve_rng_state=False)
        for i in range(0, n_tok, chunk)])
    return nll.sum(), n_tok


def prefill(params, batch, cfg: ModelConfig, last_index=None, prefix=None):
    """Forward the prompt; return (last-token logits, caches).

    ``batch``: ``{"tokens": (B, S) int}``, with ``"frames"`` or
    ``"patches"`` for an encoder-decoder or vision config (see
    :func:`loss_fn`); their ``"adx"`` layers return ``xk``/``xv`` leaves of
    the memory's length.

    ``last_index`` — optional (B,) int index of each request's last real
    prompt token, for right-padded (bucketed) prompts: logits are read
    there instead of at ``S - 1``.  Causal masking makes every position
    <= ``last_index`` independent of the padding, so bucketed prefill is
    exact for full-attention stacks; a sliding-window cache keeps pad KV
    inside its ring once the padded length exceeds the window, so the
    scheduler buckets windowed prompts only while ``padded <= window``.

    ``prefix`` — optional mapped-prefix KV tree (``{layer: {"k": (ns, 1,
    m, ...), ...}}`` per super-block, as returned by
    ``PagedCachePool.read_prefix``): ``batch["tokens"]`` is then the
    *divergent tail* of the prompt, resumed at absolute position ``m`` —
    positions/RoPE shift by ``m``, attention reads concat(prefix, tail)
    keys, and the returned caches hold the tail only (the paged pool
    scatters them at block offset ``m``).
    """
    _check_supported(cfg)
    with _transient_ctx(cfg), span("model.prefill"):
        tokens = batch["tokens"]
        x = _embed_in(params, tokens, cfg)
        memory = _memory(params, batch, cfg)
        off = 0
        if prefix is not None:
            off = next(iter(prefix.values()))["k"].shape[2]
        positions = off + torch.arange(tokens.shape[1], device=tokens.device)
        x, caches = _decoder_stack(params, x, cfg, positions=positions,
                                   mode="prefill", caches=prefix,
                                   memory=memory)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if last_index is None:
            xl = x[:, -1]
        else:
            li = torch.as_tensor(last_index, device=x.device).long()
            xl = x[torch.arange(x.shape[0], device=x.device), li]
        return _logits(xl, _unembed_table(params, cfg), cfg), caches


def prefill_packed(params, tokens, positions, segment_ids, last_index,
                   cfg: ModelConfig):
    """Prefill several prompts packed into one (1, L) token stream.

    ``positions`` (L,) restarts at 0 for each prompt (driving RoPE and the
    causal mask), ``segment_ids`` (L,) keeps attention block-diagonal — one
    prompt's tokens never attend to another's (padding carries segment id
    -1 and matches no real segment).  ``last_index`` (K,) indexes each
    segment's final prompt token in the stream.  Returns ``((K, V) logits,
    packed caches)`` — cache leaves keep the raw packed (1, L) layout;
    ``PagedCachePool.admit(start=)`` unpacks each segment.
    """
    _check_supported(cfg)
    with _transient_ctx(cfg), span("model.prefill"):
        positions = torch.as_tensor(positions, device=tokens.device).long()
        x = _embed_in(params, tokens, cfg)
        x, caches = _decoder_stack(params, x, cfg, positions=positions,
                                   mode="prefill",
                                   segment_ids=segment_ids)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        li = torch.as_tensor(last_index, device=x.device).long()
        xl = x[0, li]                                   # (K, d)
        table = _unembed_table(params, cfg)
        # one (1, d) unembed per segment: the row the unpacked prefill
        # runs, so each segment keeps that prefill's reduction order
        logits = torch.cat([_logits(xl[i:i + 1], table, cfg)
                            for i in range(xl.shape[0])], dim=0)
        return logits, caches


def decode_step(params, token, pos, caches, cfg: ModelConfig):
    """One greedy decode step. token: (B, 1) int; pos: scalar int.
    Updates ``caches`` in place."""
    _check_supported(cfg)
    with _pim_ctx(cfg), span("model.decode_step"):
        x = _embed_in(params, token, cfg)
        positions = torch.full((1,), int(pos), dtype=torch.int64,
                               device=token.device)
        x, new_caches = _decoder_stack(params, x, cfg, positions=positions,
                                       mode="decode", caches=caches,
                                       pos=int(pos))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = _logits(x[:, -1], _unembed_table(params, cfg), cfg)
        next_tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        return next_tok, logits, new_caches


def decode_step_slots(params, tokens, pos, active, caches, cfg: ModelConfig,
                      block_tables=None):
    """One decode step over a slot batch (continuous batching).

    ``tokens``: (B, 1) int current token per slot; ``pos``: (B,) int
    absolute position of that token per slot; ``active``: (B,) bool slot
    occupancy.  Shapes are fixed at ``B = max_batch``: slots attend only
    up to their own ``pos``, and finished/empty slots keep computing on
    stale state — an inactive slot writes its garbage KV at its own
    position (contiguous) or, through its all-sentinel table row, into the
    trash block (paged); its emitted token is pinned to 0.

    ``block_tables`` (B, blocks_per_slot) int switches the attention
    leaves to the block-paged layout.  Updates ``caches`` in place.
    """
    _check_supported(cfg)
    with _pim_ctx(cfg), span("model.decode_step"):
        pos = pos.long()
        x = _embed_in(params, tokens, cfg)
        x, new_caches = _decoder_stack(
            params, x, cfg, positions=pos[:, None], mode="decode",
            caches=caches, pos=pos,
            block_tables=None if block_tables is None
            else block_tables.long())
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = _logits(x[:, -1], _unembed_table(params, cfg), cfg)
        next_tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        next_tok = torch.where(active[:, None], next_tok,
                               torch.zeros_like(next_tok))
        return next_tok, logits, new_caches


def decode_run_slots(params, tokens, pos, active, caches, cfg: ModelConfig,
                     block_tables=None):
    """Verify a run of ``S`` candidate tokens per slot in one decode step.

    The speculative-decoding verify pass: ``tokens`` (B, S) int holds, per
    slot, the current token followed by ``S - 1`` drafted tokens; ``pos``
    (B,) int is the absolute position of ``tokens[:, 0]``.  Token ``i`` is
    fed at position ``pos + i``, its KV row written at that logical index
    (overwriting whatever the drafting pass left there), and its greedy
    continuation read out — the returned ``verify_tok`` (B, S) int32 is
    ``argmax(logits[:, i])`` for every ``i``.  The caller accepts the
    longest prefix where ``verify_tok[:, i] == tokens[:, i + 1]`` and
    rewinds past the rejected tail: the rejected rows hold garbage KV, but
    every mask here is position-gated (``row <= query pos``), so the next
    run overwrites a garbage row before any query can see it.  Sliding
    windows raise: rollback would need ring rows the run overwrote.

    Row ``i`` gives the bits of the single-position step at the same
    position with the same fed prefix: every linear lowering quantizes
    per activation row, and the norms, attention and the unembed (one
    (B, d) matmul per position) run one position at a time.  An MoE block
    routes all ``B * S`` rows together, as the reference does, so its
    capacity counts them all (the scheduler refuses speculation for MoE).  Writes at or
    past a slot's capacity go to the trash block (paged) or are dropped
    (contiguous).  Updates ``caches`` in place.
    """
    _check_supported(cfg)
    with _pim_ctx(cfg), span("model.decode_step"):
        pos = pos.long()
        run = torch.arange(tokens.shape[1], device=tokens.device)
        x = _embed_in(params, tokens, cfg)
        x, new_caches = _decoder_stack(
            params, x, cfg, positions=pos[:, None] + run[None, :],
            mode="decode", caches=caches, pos=pos,
            block_tables=None if block_tables is None
            else block_tables.long())
        table = _unembed_table(params, cfg)
        # one (B, d) unembed per run position: the row the single-position
        # step runs (a (B * S, d) matmul may reduce in another order)
        logits = torch.stack(
            [_logits(rms_norm(x[:, i:i + 1].contiguous(),
                              params["final_norm"], cfg.norm_eps)[:, -1],
                     table, cfg) for i in range(tokens.shape[1])], dim=1)
        verify_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        verify_tok = torch.where(active[:, None], verify_tok,
                                 torch.zeros_like(verify_tok))
        return verify_tok, logits, new_caches


# ==========================================================================
# cache specs
# ==========================================================================

def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict:
    """``(shape, dtype)`` of the contiguous decode caches: KV for the
    attention kinds, slot-indexed cross-attention memory for ``"adx"``
    (``xk``, ``xv``: ``n_patches`` rows, or ``seq_len // audio_frames_div``
    for an encoder's frames) and recurrent state for Mamba (``ssm``,
    ``conv``) and xLSTM (``c``, ``n``, ``m``); a layer with no leaves has
    no entry."""
    _check_supported(cfg)
    ns, nh, hkv, hd = cfg.n_super, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    f32 = torch.float32
    kv_dt = torch.int8 if cfg.kv_cache_dtype == "int8" else cfg.compute_dtype
    # a sliding window's ring holds at most the window
    cap = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    out: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.pattern):
        c: Dict[str, Any] = {}
        if kind in _ATTN_KINDS:
            c["k"] = ((ns, batch, cap, hkv, hd), kv_dt)
            c["v"] = ((ns, batch, cap, hkv, hd), kv_dt)
            if cfg.kv_cache_dtype == "int8":
                c["k_scale"] = ((ns, batch, cap, hkv), f32)
                c["v_scale"] = ((ns, batch, cap, hkv), f32)
        if kind == "adx":
            rows = cfg.n_patches or seq_len // cfg.audio_frames_div
            for key in _XATTN_KEYS:
                c[key] = ((ns, batch, rows, hkv, hd), cfg.compute_dtype)
        if kind == "ms":
            ds = cfg.mamba_d_state
            c["ssm"] = ((ns, batch, cfg.mamba_n_heads, cfg.mamba_d_head, ds),
                        f32)
            c["conv"] = ((ns, batch, cfg.mamba_d_conv - 1,
                          cfg.d_inner + 2 * ds), cfg.compute_dtype)
        elif kind in _MAMBA_KINDS:
            c["ssm"] = ((ns, batch, cfg.d_inner, cfg.mamba_d_state), f32)
            c["conv"] = ((ns, batch, cfg.mamba_d_conv - 1, cfg.d_inner),
                         cfg.compute_dtype)
        if kind in _XLSTM_KINDS:
            _, dh = _xlstm_inner(cfg)
            per_head = (dh, dh) if kind == "xm" else (dh,)
            c["c"] = ((ns, batch, nh) + per_head, f32)
            c["n"] = ((ns, batch, nh) + per_head[1:], f32)
            c["m"] = ((ns, batch, nh), f32)
        if c:
            out[str(i)] = c
    return out


def paged_cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                      num_blocks: int, block_size: int) -> Dict:
    """``cache_specs`` with the attention-KV leaves re-laid as
    ``(n_super, num_blocks, block_size, ...)`` block pools (block 0 is the
    pool's reserved sentinel/trash block); the cross-attention and
    recurrent leaves keep their ``(n_super, batch, ...)`` slot layout."""
    out = cache_specs(cfg, batch, seq_len)
    for c in out.values():
        for key in PAGED_KV_KEYS:
            if key in c:
                shape, dt = c[key]
                c[key] = ((shape[0], num_blocks, block_size) + shape[3:], dt)
    return out


def zeros_like_specs(specs: Dict, device) -> Dict:
    """Allocate a zeroed cache tree from ``(shape, dtype)`` specs."""
    return {i: {k: torch.zeros(shape, dtype=dt, device=device)
                for k, (shape, dt) in c.items()} for i, c in specs.items()}


def param_count(cfg: ModelConfig) -> int:
    return int(sum(math.prod(shape)
                   for _, (shape, *_) in _leaves(param_specs(cfg))))


__all__ = ["PAGED_KV_KEYS", "param_specs", "draw_leaves", "init_params",
           "from_reference", "apply_block", "loss_fn", "nll_sum", "prefill",
           "prefill_packed", "decode_step", "decode_step_slots",
           "decode_run_slots", "ring_slot_positions", "cache_specs",
           "paged_cache_specs", "zeros_like_specs", "param_count"]
