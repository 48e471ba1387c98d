"""Attention: GQA/MQA, sliding-window masks, KV-cache decode, and
cross-attention onto an encoder's or a vision projection's memory.

Eager PyTorch: these are plain jnp functions in the reference, not Pallas
kernels.  ``flash_attention`` keeps the reference's blockwise online
softmax (query/key blocks of 512), so memory is O(Bq*Bk) per block pair;
``direct_attention`` materializes the scores.  Scores and the weighted sum
accumulate in float32, as the reference's ``preferred_element_type``
does.  ``scale`` replaces the scores' ``1 / sqrt(D)`` where a model sets
its own (granite-4.0-h's attention multiplier); None keeps it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _positions(sq: int, sk: int, q_offset: int, positions, device):
    """(q positions, k positions): ``positions`` (packed prefill; needs
    Sq == Sk) for both, else ``q_offset + arange(Sq)`` and ``arange(Sk)``."""
    if positions is not None:
        if sq != sk:
            raise ValueError("positions requires Sq == Sk (packed prefill)")
        pos = torch.as_tensor(positions, device=device).long()
        return pos, pos
    return (q_offset + torch.arange(sq, device=device),
            torch.arange(sk, device=device))


def _scaled(s, d: int, scale: Optional[float]):
    """Scores over ``sqrt(d)``, or times ``scale`` when one is given."""
    return s / math.sqrt(d) if scale is None else s * scale


def direct_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                     q_offset: int = 0, segment_ids=None,
                     positions=None, scale: Optional[float] = None
                     ) -> torch.Tensor:
    """Materialized-scores attention. q: (B, Sq, H, D), k/v: (B, Sk, Hkv, D).

    ``positions``/``segment_ids``: packed-prefill support.  ``positions``
    (S,) replaces the arange-derived q/k positions (requires Sq == Sk —
    q and k cover the same packed token stream); ``segment_ids`` (S,)
    adds a block-diagonal mask so tokens never attend across segments.
    """
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    s = _scaled(torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                             k.to(torch.float32)), d, scale)
    q_pos, k_pos = _positions(sq, sk, q_offset, positions, q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=q.device)
        mask &= seg[:, None] == seg[None, :]
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(torch.float32),
                        v.to(torch.float32)).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                    q_offset: int = 0, block_q: int = 512,
                    block_k: int = 512, segment_ids=None,
                    positions=None, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, Hkv, D) -> (B, Sq, H, D).

    ``q_offset``: absolute position of q[0] (for prefill continuation).
    ``window``: sliding-window radius (attend to keys in (pos-window, pos]).
    ``positions``/``segment_ids``: packed-prefill support — ``positions``
    (S,) replaces the arange-derived positions for both q and k (requires
    Sq == Sk), ``segment_ids`` (S,) masks cross-segment pairs.
    """
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = q.device
    qt = q.permute(0, 2, 1, 3)            # (B, H, Sq, D)
    kt = k.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    q_all, k_all = _positions(sq, sk, q_offset, positions, dev)
    seg = (None if segment_ids is None
           else torch.as_tensor(segment_ids, device=dev))
    outs = []
    for q0 in range(0, sq, block_q):
        qblk = qt[:, :, q0:q0 + block_q].to(torch.float32)
        bq = qblk.shape[2]
        q_pos = q_all[q0:q0 + bq]
        m = torch.full((b, h, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, bq, d), dtype=torch.float32, device=dev)
        for k0 in range(0, sk, block_k):
            kblk = kt[:, :, k0:k0 + block_k]
            vblk = vt[:, :, k0:k0 + block_k]
            k_pos = k_all[k0:k0 + kblk.shape[2]]
            s = torch.einsum("bhqd,bhkd->bhqk", qblk,
                             kblk.to(torch.float32)) * scale
            mask = torch.ones((bq, kblk.shape[2]), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            if seg is not None:
                mask &= (seg[q0:q0 + bq, None]
                         == seg[None, k0:k0 + kblk.shape[2]])
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vblk.dtype).to(torch.float32),
                vblk.to(torch.float32))
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3)


def decode_attention(q, k_cache, v_cache, cache_len=None, *,
                     window: Optional[int] = None,
                     valid: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Decode-step attention: q (B, Sq, H, D) over cache (B, S, Hkv, D).

    The key mask comes from ``cache_len`` (prefix semantics: indices below
    it are live; a scalar, or (B, 1) per slot; with ``window`` only the
    last ``window`` of them, the reference's clip)
    or, for non-contiguous cache layouts, from an explicit ``valid`` (B, S)
    boolean mask — the paged pool's gather path computes per-logical-index
    validity (unallocated sentinel blocks) that a prefix length can't
    express — or a per-query (B, Sq, S) mask.
    """
    b, sq, h, d = q.shape
    _, s, hkv, _ = k_cache.shape
    n_rep = h // hkv
    qg = q.reshape(b, sq, hkv, n_rep, d)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg.to(torch.float32),
                          k_cache.to(torch.float32))
    scores = _scaled(scores, d, scale)
    if valid is not None:
        mask = valid
    else:
        pos = torch.arange(s, device=q.device)
        mask = pos[None, :] < cache_len
        if window is not None:
            mask = mask & (pos[None, :] > cache_len - 1 - window)
    if mask.dim() == 3:          # per-query validity (B, Sq, S)
        mask5 = mask[:, None, None, :, :]
    else:
        mask5 = torch.broadcast_to(mask, (b, s))[:, None, None, None, :]
    scores = torch.where(mask5, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgqs,bshd->bqhgd", p.to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(b, sq, h, d).to(q.dtype)


def cross_attention(q, k, v) -> torch.Tensor:
    """Full (unmasked) attention onto a memory of frames or patches: q (B,
    Sq, H, D), k/v (B, Sk, Hkv, D) -> (B, Sq, H, D).  float32 scores over
    ``sqrt(D)``, the softmax cast to ``v``'s dtype, float32 accumulation
    cast to ``q``'s."""
    h, d, hkv = q.shape[2], q.shape[3], k.shape[2]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(d)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(torch.float32),
                        v.to(torch.float32)).to(q.dtype)
