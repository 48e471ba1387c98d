"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

mLSTM: the pre-up-projection block — up-project to ``pf * d``, q/k/v heads
over the inner dim (block-diagonal per-head projections), exponential
input/forget gating with the max-state stabilizer, matrix memory C (B, NH,
dh, dh) and normalizer n (B, NH, dh).  sLSTM: the scalar-memory variant
with exponential gating, gates from the current input only (the
reference's simplification), followed by the same up/down projection.

Both recurrences run as a float32 Python loop over the sequence, in the
reference's step order; decode is one step from the carried ``(c, n,
m)``.  The projections are plain products in the compute dtype, outside
``linear``, as in the reference.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

__all__ = ["mlstm_block", "slstm_block"]

#: the stabilizer's start: exp(f + m0 - m) is 0 at the first step
_M0 = -1e30


def _heads(x, nh):
    b, s, p = x.shape
    return x.reshape(b, s, nh, p // nh)


def _fresh(b, nh, dims_c, dims_n, device):
    f32 = torch.float32
    return (torch.zeros((b, nh) + dims_c, dtype=f32, device=device),
            torch.zeros((b, nh) + dims_n, dtype=f32, device=device),
            torch.full((b, nh), _M0, dtype=f32, device=device))


def mlstm_block(x, params: Dict, cfg, state=None):
    """x: (B, S, d) -> (y, new_state).

    ``state``: (C (B,NH,dh,dh), n (B,NH,dh), m (B,NH)) or None."""
    b, s, _ = x.shape
    nh = cfg.n_heads
    cdt = x.dtype
    up = x @ params["up_proj"].to(cdt)                # (B, S, 2p)
    xm, z = torch.chunk(up, 2, dim=-1)                # (B, S, p)
    p = xm.shape[-1]
    dh = p // nh

    xh = _heads(xm, nh)                               # (B, S, NH, dh)
    q = torch.einsum("bshd,hde->bshe", xh, params["wq"].to(cdt))
    k = torch.einsum("bshd,hde->bshe", xh, params["wk"].to(cdt)) \
        / torch.sqrt(torch.tensor(dh, dtype=cdt))
    v = torch.einsum("bshd,hde->bshe", xh, params["wv"].to(cdt))
    gates = xm @ params["w_gates"].to(cdt)            # (B, S, 2*NH)
    ig, fg = torch.chunk(gates.to(torch.float32), 2, dim=-1)  # (B, S, NH)

    if state is None:
        c, n, m = _fresh(b, nh, (dh, dh), (dh,), x.device)
    else:
        c, n, m = [t.to(torch.float32) for t in state]

    q32 = q.to(torch.float32)
    hs = []
    for t in range(s):
        qt, kt, vt, it, ft = q32[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t]
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        c = f_p[..., None, None] * c + i_p[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])      # (B,NH,dh,dh)
        n = f_p[..., None] * n + i_p[..., None] * kt
        m = m_new
        num = torch.einsum("bhij,bhj->bhi", c, qt)
        den = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh", n, qt)),
                          min=1.0)
        hs.append((num / den[..., None]).to(cdt))
    h = torch.stack(hs, dim=1).reshape(b, s, p)
    h = h * F.silu(z)
    y = h @ params["down_proj"].to(cdt)
    return y, (c, n, m)


def slstm_block(x, params: Dict, cfg, state=None):
    """Scalar-memory sLSTM with exponential gating; state (c, n, m)."""
    b, s, _ = x.shape
    nh = cfg.n_heads
    cdt = x.dtype
    up = x @ params["up_proj"].to(cdt)
    xm, zg = torch.chunk(up, 2, dim=-1)
    p = xm.shape[-1]
    dh = p // nh

    zt = torch.tanh(torch.einsum("bshd,hde->bshe", _heads(xm, nh),
                                 params["wz"].to(cdt)))    # (B,S,NH,dh)
    gates = (xm @ params["w_gates"].to(cdt)).to(torch.float32)
    ig, fg, og = torch.chunk(gates, 3, dim=-1)             # (B,S,NH)

    if state is None:
        c, n, m = _fresh(b, nh, (dh,), (), x.device)
    else:
        c, n, m = [t.to(torch.float32) for t in state]

    z32 = zt.to(torch.float32)
    hs = []
    for t in range(s):
        i_t, f_t, o_t = ig[:, t], fg[:, t], og[:, t]
        m_new = torch.maximum(f_t + m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(f_t + m - m_new)
        c = f_p[..., None] * c + i_p[..., None] * z32[:, t]
        n = f_p * n + i_p
        m = m_new
        h = torch.sigmoid(o_t)[..., None] * c \
            / torch.clamp(n, min=1.0)[..., None]
        hs.append(h.to(cdt))
    h = torch.stack(hs, dim=1).reshape(b, s, p)
    h = h * F.silu(zg)
    y = h @ params["down_proj"].to(cdt)
    return y, (c, n, m)
