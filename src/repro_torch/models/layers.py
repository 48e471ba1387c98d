"""Primitive layers: norms, rotary embeddings, activations, linears, embed.

Parameters are plain nested dicts of tensors.  Their specs are
:class:`Spec` leaves (shape, dtype, init kind, scale): :func:`materialize`
draws real parameters from a spec tree, :func:`as_shapes` strips it to
``(shape, dtype)`` leaves (what the dry run lays out without allocating).

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

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.runtime.trace import span
from repro_torch.tree import leaves, rebuild

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# spec / init plumbing
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Spec:
    """One parameter's spec: shape, dtype and init kind — ``"normal"``
    (std ``scale / sqrt(fan_in)``), ``"zeros"``, ``"ones"`` or ``"alog"``
    (``log(1..d_state)`` along the last dim) — as the reference's
    ``layers.Spec``.  It unpacks and indexes as ``(shape, dtype, init,
    scale)``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str = "normal"
    scale: float = 1.0

    def __iter__(self) -> Iterator:
        return iter((self.shape, self.dtype, self.init, self.scale))

    def __getitem__(self, i):
        return tuple(self)[i]


def _leaf_generator(seed: int, i: int, dev) -> torch.Generator:
    """The generator of random leaf ``i``: seeded from
    ``numpy.random.SeedSequence([seed, i])``, on ``dev``."""
    g = torch.Generator(device=dev)
    g.manual_seed(int(np.random.SeedSequence([seed, i]).generate_state(
        1, np.uint64)[0]))
    return g


def draw_specs(specs, seed: int = 0, device="cuda"):
    """``(path, tensor)`` of every leaf of the spec tree ``specs``, drawn
    one after another on ``device`` in sorted-path order, random leaf
    ``i`` by ``normal_`` straight into its dtype from
    :func:`_leaf_generator` ``(seed, i)``; each leaf is dropped here before
    the next is drawn."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    i = 0
    for path, (shape, dt, init, scale) in leaves(specs):
        if init == "zeros":
            t = torch.zeros(shape, dtype=dt, device=dev)
        elif init == "ones":
            t = torch.ones(shape, dtype=dt, device=dev)
        elif init == "alog":
            # S4/Mamba A = -(1..d_state) per channel: d_state values
            row = np.log(np.arange(1, shape[-1] + 1, dtype=np.float32))
            t = torch.from_numpy(row).to(dev).expand(shape).to(dt)
            t = t.contiguous()
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            t = torch.empty(shape, dtype=dt, device=dev).normal_(
                0.0, scale / math.sqrt(max(1, fan_in)),
                generator=_leaf_generator(seed, i, dev))
            i += 1
        yield path, t
        del t  # the next leaf is drawn with this one gone


def materialize(specs, seed: int = 0, device="cuda") -> Params:
    """Instantiate a spec tree into real parameters on ``device``
    (:func:`draw_specs`'s leaves, in the tree's nesting)."""
    out: Params = {}
    for path, t in draw_specs(specs, seed, device):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def as_shapes(specs):
    """Strip init metadata: ``(shape, dtype)`` leaves."""
    return rebuild(specs, ((tuple(sp.shape), sp.dtype)
                           for _, sp in leaves(specs)))


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

    with span("linear"):
        mode = engine.resolve_mode(mode)
        if mode == "quant":
            from repro_torch.kernels.quant_matmul import quant_linear

            # quant_linear casts w to float32 inside its quantization
            y = quant_linear(x, w)
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
