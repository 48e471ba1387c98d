"""Mamba selective-SSM mixer (Jamba's recurrent block).

Prefill and training run the recurrence as a Python loop over the
sequence, in float32 and in the reference's step order (``h = da * h +
dbu``, then ``y = h . c``); the step's inputs ``da`` and ``dbu`` are
elementwise, so they are formed for the whole sequence before the loop.
Decode is a single-step state update: state ``(B, d_inner, d_state)``
plus the conv tail ``(B, d_conv - 1, d_inner)``, O(1) per token.

The projections are plain products in the compute dtype, outside
``linear``, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.runtime.trace import span

__all__ = ["mamba_mixer"]


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
