"""AdamW on the port's parameter dicts, with the reference's options:
configurable moment dtypes and an Adafactor-style factored second moment
(rank-1 row/column statistics for leaves of at least 2 dimensions) that
cuts optimizer state from 8 bytes per parameter to about 2.

The state tree is the reference's: ``{"step": int32 scalar, "leaves":
{...same nesting as params...: {"m", "v"} or {"m", "vr", "vc"}}}``, so a
checkpoint of it restores in either package.  :func:`apply_updates`
updates the parameters and the state **in place** (under
``torch.no_grad()``) and returns them: a full-width model never holds two
copies of its state, as the reference's buffer donation avoids.  The
learning rate and the gradient norm come back as device tensors, so a
training loop synchronizes only where it reads them.

On a ZeRO-3 tree (``dist.zero``) the parameters, gradients and moments
are this rank's shards: every update is elementwise, so it runs on the
shards as it would on the whole leaves.  Given the spec tree and the
mesh, :func:`global_norm` counts every element once (each rank's sum of
squares, all-reduced over the axes its leaf is sharded on only, so a
leaf replicated on ``"model"`` is not counted twice), and clipping scales
every shard alike.  Factored moments reduce over whole rows and columns:
on a shard each mean is the rank's, averaged over the axes that shard
the reduced dim (:func:`_whole_mean`, equal shards), so every rank holds
its block of the whole leaf's statistics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.tree import leaves, rebuild

__all__ = ["AdamWConfig", "init_state", "apply_updates", "cosine_schedule",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"      # "float32" | "bfloat16"
    factored: bool = False             # factored second moment (>=2D leaves)
    factored_min_dim: int = 128


def cosine_schedule(cfg: AdamWConfig, step):
    """Linear warmup to ``lr_peak``, then cosine decay to ``lr_min``, as a
    float32 tensor (on ``step``'s device when ``step`` is a tensor)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * t))
    return warm * cos


def _mdt(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def _is_factored(cfg: AdamWConfig, shape) -> bool:
    return (cfg.factored and len(shape) >= 2
            and shape[-1] >= cfg.factored_min_dim
            and shape[-2] >= cfg.factored_min_dim)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def init_state(cfg: AdamWConfig, params) -> Dict[str, Any]:
    """Zero moments for every leaf of ``params``, on each leaf's device."""
    mdt = _mdt(cfg)

    def leaf_state(p):
        dev = p.device
        st = {"m": torch.zeros(p.shape, dtype=mdt, device=dev)}
        if _is_factored(cfg, p.shape):
            st["vr"] = torch.zeros(p.shape[:-1], dtype=torch.float32,
                                   device=dev)                  # row stats
            st["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                   dtype=torch.float32, device=dev)
        else:
            st["v"] = torch.zeros(p.shape, dtype=torch.float32, device=dev)
        return st

    ps = [p for _, p in leaves(params)]
    return {"step": torch.zeros((), dtype=torch.int32, device=ps[0].device),
            "leaves": rebuild(params, map(leaf_state, ps))}


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.  With
    ``specs`` (a spec tree) and ``mesh`` the leaves are this rank's
    shards: the squares of leaves sharded on the same axes are summed and
    all-reduced over those axes, once per distinct set of axes."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for _, x in leaves(tree)]
    if specs is None:
        return torch.sqrt(sum(sq))
    from repro_torch.dist import context as dctx

    by_axes: Dict[tuple, Any] = {}
    for v, (_, sp) in zip(sq, leaves(specs)):
        axes = tuple(a for a in mesh.axis_names if any(
            e == a or (isinstance(e, tuple) and a in e) for e in sp))
        by_axes[axes] = by_axes.get(axes, 0) + v
    total = 0
    for axes in sorted(by_axes):
        v = by_axes[axes]
        if axes:
            v = dctx.all_reduce(v.reshape(1).to(mesh.comm_device, copy=True),
                                axes, "sum", mesh).to(v.device)[0]
        total = total + v
    return torch.sqrt(total)


def _whole_mean(x: torch.Tensor, entry, mesh) -> torch.Tensor:
    """A mean over a dim sharded on ``entry`` (None: not sharded), from
    this rank's mean over its shard of the dim: the ranks' means averaged
    over ``entry``'s axes (the shards are equal)."""
    if entry is None:
        return x
    from repro_torch.dist import context as dctx

    t = dctx.all_reduce(x.to(mesh.comm_device, copy=True), entry, "sum",
                        mesh)
    return (t / mesh.axis_size(entry)).to(x.device)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, specs=None,
                  mesh=None):
    """One AdamW step with clip-by-global-norm, bias correction and weight
    decay on every leaf (norms and biases too, as the reference does).
    Updates ``params`` and ``state`` in place; returns ``(params, state,
    {"lr", "grad_norm"})``.  ``specs`` and ``mesh``: the leaves are shards
    under those specs (see the module docstring)."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads, specs, mesh)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    for path, p in leaves(params):
        g = _at(grads, path).to(torch.float32) * scale
        st = _at(state["leaves"], path)
        m = cfg.b1 * st["m"].to(torch.float32) + (1 - cfg.b1) * g
        if "v" in st:
            v = cfg.b2 * st["v"] + (1 - cfg.b2) * g * g
            denom = torch.sqrt(v / bc2) + cfg.eps
            st["v"].copy_(v)
        else:
            g2 = g * g + 1e-30
            sp = _at(specs, path) if specs is not None else (None, None)
            row = _whole_mean(g2.mean(dim=-1), sp[-1], mesh)
            col = _whole_mean(g2.mean(dim=-2), sp[-2], mesh)
            vr = cfg.b2 * st["vr"] + (1 - cfg.b2) * row
            vc = cfg.b2 * st["vc"] + (1 - cfg.b2) * col
            # rank-1 reconstruction: v ~ vr vc / mean(vr)
            mean_r = _whole_mean(vr.mean(dim=-1, keepdim=True), sp[-2],
                                 mesh)
            v_hat = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(mean_r[..., None], min=1e-30))
            denom = torch.sqrt(v_hat / bc2) + cfg.eps
            st["vr"].copy_(vr)
            st["vc"].copy_(vc)
        update = (m / bc1) / denom + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * update)
        st["m"].copy_(m)
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}
