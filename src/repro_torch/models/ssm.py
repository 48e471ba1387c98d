"""Mamba selective-SSM mixers: Mamba-1 (Jamba's recurrent block) and
Mamba-2 (granite-4.0-h's).

Prefill and training run the recurrence as a Python loop over the
sequence, in float32 and in the reference's step order (``h = da * h +
dbu``, then ``y = h . c``); the step's inputs ``da`` and ``dbu`` are
elementwise, so they are formed for the whole sequence before the loop.
Decode is a single-step state update: state ``(B, d_inner, d_state)``
plus the conv tail ``(B, d_conv - 1, d_inner)``, O(1) per token.

The projections are plain products in the compute dtype, outside
``linear``, as in the reference.

:func:`mamba2_mixer` is Mamba-2 with one group: ``in_proj`` gives ``z``,
``xBC`` and one ``dt`` per head; a causal depthwise conv with bias and
SiLU runs over ``xBC``, which splits into ``x`` (heads of ``mamba_d_head``)
and the ``B`` and ``C`` that every head shares.  Each head decays by the
scalar ``exp(dt * A)``: ``h = exp(dt A) h + dt x B^T`` and ``y = h C + D
x``, then ``y * silu(z)`` is RMS-normed over ``d_inner`` (the gated norm)
before ``out_proj``.  Its state is ``(B, heads, d_head, d_state)``
float32 and the conv tail ``(B, d_conv - 1, d_inner + 2 d_state)``.  The
recurrence, ``dt`` and the gated norm are float32 (``dt_bias``,
``a_log``, ``d_skip`` and ``gate_norm`` are float32 leaves); prefill steps
position by position, as the Mamba-1 loop does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.runtime.trace import span

__all__ = ["mamba_mixer", "mamba2_mixer"]


def _softplus(x):
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)`` (the reference's form)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_mixer(x, params: Dict, cfg, state: Tuple = None):
    """x: (B, S, d). Returns (y, new_state).

    ``state`` = (ssm_state (B, di, ds) float32, conv_state (B, d_conv-1,
    di)) or None for a fresh sequence (training/prefill from scratch)."""
    with span("ssm.mixer"):
        b, s, _ = x.shape
        di, ds, dc = cfg.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
        dtr = cfg.dt_rank
        cdt = x.dtype

        xz = x @ params["in_proj"].to(cdt)                # (B, S, 2*di)
        xi, z = torch.split(xz, di, dim=-1)

        # causal depthwise conv over S
        conv_w = params["conv_w"].to(cdt)                 # (dc, di)
        if state is None:
            tail = torch.zeros((b, dc - 1, di), dtype=cdt, device=x.device)
        else:
            tail = state[1].to(cdt)
        xi_pad = torch.cat([tail, xi], dim=1)             # (B, S+dc-1, di)
        conv = sum(xi_pad[:, t:t + s, :] * conv_w[t] for t in range(dc))
        conv = conv + params["conv_b"].to(cdt)
        new_tail = xi_pad[:, xi_pad.shape[1] - (dc - 1):, :]
        u = F.silu(conv)                                  # (B, S, di)

        # input-dependent SSM parameters
        proj = u @ params["x_proj"].to(cdt)               # (B, S, dtr+2*ds)
        dt_r, b_t, c_t = torch.split(proj, [dtr, ds, ds], dim=-1)
        dt = _softplus(dt_r @ params["dt_proj"].to(cdt)
                       + params["dt_bias"].to(cdt))       # (B, S, di)
        a = -torch.exp(params["a_log"].to(torch.float32))  # (di, ds)

        f32 = torch.float32
        da = torch.exp(dt[..., None].to(f32) * a)         # (B, S, di, ds)
        dbu = (dt * u)[..., None].to(f32) * b_t[:, :, None, :].to(f32)
        c32 = c_t.to(f32)
        h = (torch.zeros((b, di, ds), dtype=f32, device=x.device)
             if state is None else state[0].to(f32))
        ys = []
        for t in range(s):
            h = da[:, t] * h + dbu[:, t]
            ys.append(torch.einsum("bis,bs->bi", h, c32[:, t]))
        y = torch.stack(ys, dim=1).to(cdt)                # (B, S, di)
        y = y + u * params["d_skip"].to(cdt)
        y = y * F.silu(z)
        out = y @ params["out_proj"].to(cdt)
        return out, (h, new_tail)


def gated_norm(y, z, weight, eps: float):
    """Mamba-2's gated RMSNorm in float32: ``y * silu(z)`` normed over its
    last axis, times ``weight`` (float32)."""
    g = y * F.silu(z.to(torch.float32))
    return F.rms_norm(g, (g.shape[-1],), weight, eps)


def mamba2_mixer(x, params: Dict, cfg, state: Tuple = None):
    """x: (B, S, d). Returns (y, new_state).

    ``state`` = (ssm_state (B, nh, hd, ds) float32, conv_state (B,
    d_conv-1, d_inner + 2 ds)) or None for a fresh sequence.  Written for
    few launches a decode step: the conv is one product over the unfolded
    window, and each position's state update two."""
    with span("ssm.mamba2"):
        b, s, _ = x.shape
        di, ds, dc = cfg.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
        nh, hd = cfg.mamba_n_heads, cfg.mamba_d_head
        cdt, f32 = x.dtype, torch.float32

        z, xbc, dt = torch.split(x @ params["in_proj"].to(cdt),
                                 [di, di + 2 * ds, nh], dim=-1)
        if state is None:
            tail = torch.zeros((b, dc - 1, di + 2 * ds), dtype=cdt,
                               device=x.device)
        else:
            tail = state[1]
        pad = torch.cat([tail, xbc], dim=1)              # (B, S+dc-1, C)
        new_tail = pad[:, s:]
        # the causal depthwise conv in float32 (the taps are float32)
        conv = (pad.unfold(1, dc, 1) * params["conv_w"].T).sum(-1) \
            + params["conv_b"]
        xs, b_t, c_t = torch.split(F.silu(conv), [di, ds, ds], dim=-1)
        xh = xs.reshape(b, s, nh, hd)

        # the float32 leaves (dt_bias, a_log, d_skip) per head
        dt = F.softplus(dt + params["dt_bias"])           # (B, S, nh)
        da = torch.exp(dt * -torch.exp(params["a_log"])).view(b, s, nh, 1,
                                                              1)
        dbx = (dt[..., None] * xh)[..., None] * b_t.view(b, s, 1, 1, ds)
        c_col = c_t.view(b, s, 1, ds, 1)
        h = (torch.zeros((b, nh, hd, ds), dtype=f32, device=x.device)
             if state is None else state[0])
        ys = []
        for t in range(s):
            h = da[:, t] * h + dbx[:, t]
            ys.append(h @ c_col[:, t])                    # (B, nh, hd, 1)
        y = torch.stack(ys, dim=1).view(b, s, nh, hd) \
            + xh * params["d_skip"].view(nh, 1)
        g = gated_norm(y.view(b, s, di), z, params["gate_norm"],
                       cfg.norm_eps)
        out = g.to(cdt) @ params["out_proj"].to(cdt)
        return out, (h, new_tail)
