"""ZeRO-3 storage: each rank keeps only its shard of every leaf.

Until the sharded trainer every rank held the whole tree
(``dist.context``).  Here a leaf lives as this rank's shard under its spec
(``partitioning.param_pspecs(..., fsdp=True)``): dim ``d`` with entry
``A`` keeps block ``mesh.index(A)`` of ``mesh.axis_size(A)``.  A group's
ranks are in the row-major order of their coordinates on ``A``
(``context.Mesh``), which is how ``NamedSharding`` tiles a dim over the
same axes, so a rank's shard is the one the reference puts on the device
at the same mesh position.

:func:`gather_leaf` is the forward's gather at a leaf's use, an autograd
function.  Its backward all-reduces the gradient (SUM) over the whole
world and keeps this rank's shard: every rank adds its loss contribution
(``launch.train.train_step`` divides each rank's token-sum by the world's
token count), and a leaf used whole on every rank takes a gradient from
every rank.  Gloo has no ``reduce_scatter``, so the all-reduce plus a
slice stands in for it, at twice its bytes; the gather's transpose is the
reduce-scatter the reference's comment at ``models/moe.py:104-106`` relies
on.  :func:`gather_experts` is the MoE's: the rank's own experts only,
never the whole leaf.  :func:`psum` and :func:`gather_rows` are the
expert-parallel block's collectives with their transposes.

:class:`Gathered` wraps a shard tree and its specs for the model: reading
a leaf gathers it (once per wrapper for whole leaves, at every read for a
layer's view), so no gathered leaf outlives the step that read it.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.dist import context as dctx
from repro_torch.tree import leaves, rebuild

__all__ = ["shard_leaf", "gather_leaf", "shard_tree", "gather_tree",
           "shard_bytes", "Gathered", "gather_experts", "psum",
           "gather_rows"]


def _axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(mesh, entry, size: int) -> Tuple[int, int]:
    """(start, length) of this rank's block of a dim of ``size`` sharded
    over ``entry``."""
    n = mesh.axis_size(_axes(entry))
    if size % n:
        raise ValueError(f"dim of {size} does not split over {entry} = {n}")
    step = size // n
    return mesh.index(_axes(entry)) * step, step


def shard_leaf(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's shard of the whole leaf ``x`` under ``spec``: a copy in
    storage of its own, so freeing ``x`` frees the whole leaf (a narrow of
    dim 0 alone is contiguous, and ``contiguous()`` would return that
    view, which keeps all of ``x``'s storage alive)."""
    if len(spec) != x.dim():
        raise ValueError(f"spec {tuple(spec)} for a rank-{x.dim()} leaf")
    out = x
    for d, entry in enumerate(spec):
        if entry is not None:
            start, n = _block(mesh, entry, out.shape[d])
            out = out.narrow(d, start, n)
    return out.clone(memory_format=torch.contiguous_format)


def _gather(shard: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    out = shard
    for d, entry in enumerate(spec):
        if entry is not None:
            out = dctx.all_gather(out, _axes(entry), dim=d, mesh=mesh)
    return out


def _world_sum(g: torch.Tensor, mesh) -> torch.Tensor:
    g = g.contiguous().clone()
    return dctx.all_reduce(g, tuple(mesh.axis_names), "sum", mesh)


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, spec, mesh):
        ctx.spec, ctx.mesh = tuple(spec), mesh
        return _gather(shard, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return shard_leaf(_world_sum(g, ctx.mesh), ctx.spec, ctx.mesh), \
            None, None


def gather_leaf(shard: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The whole leaf, gathered over every sharded dim of ``spec``; its
    backward sums the gradient over the world and keeps this rank's
    shard (a leaf replicated on every rank takes every rank's gradient
    too)."""
    return _GatherLeaf.apply(shard, tuple(spec), mesh)


def shard_tree(tree, specs, mesh):
    """:func:`shard_leaf` of every leaf of ``tree`` under ``specs``."""
    flat = [s for _, s in leaves(specs)]
    return rebuild(tree, (shard_leaf(x, s, mesh) for (_, x), s
                          in zip(leaves(tree), flat)))


@torch.no_grad()
def gather_tree(tree, specs, mesh, device=None):
    """Every leaf of a shard tree gathered whole (a collective: every rank
    calls it), each moved to ``device`` (default: where it is) as soon as
    it is gathered, so a checkpoint's tree never sits whole on the card."""
    flat = [s for _, s in leaves(specs)]
    out = []
    for (_, x), s in zip(leaves(tree), flat):
        g = _gather(x, s, mesh) if x.dim() else x
        out.append(g if device is None else g.to(device))
    return rebuild(tree, out)


def shard_bytes(shapes, specs, mesh, itemsizes) -> int:
    """Host arithmetic: the bytes of this rank's shards of leaves of
    ``shapes`` (a tree of shapes or tensors) under ``specs``, each leaf at
    the element size of the matching leaf of ``itemsizes``."""
    from repro_torch.dist.partitioning import leaf_shape

    total = 0
    for (_, sh), (_, sp), (_, isz) in zip(leaves(shapes), leaves(specs),
                                          leaves(itemsizes)):
        n = math.prod(leaf_shape(sh))
        for entry in sp:
            if entry is not None:
                n //= mesh.axis_size(_axes(entry))
        total += n * int(isz)
    return total


class Gathered(Mapping):
    """A read-only view of a shard tree that gathers a leaf where the model
    reads it.

    ``tree`` and ``specs`` have the same nesting; ``mesh`` is the mesh the
    shards live on.  Reading a whole leaf gathers it once per wrapper (the
    tied embedding's two uses share one gather).  :meth:`layer` is layer
    ``i`` of a dict of stacked block leaves: each read gathers layer
    ``i``'s slice of the shard again, so a checkpointed block's recompute
    gathers its own copy and none is kept between the forward and the
    backward.  :meth:`shard` and :meth:`spec` hand the raw shard and its
    spec to a caller that gathers for itself (the MoE's experts).
    ``row_axes`` names the mesh axes the activations' rows are split over
    (the trainer's rows of the batch; ``()``: every rank holds the whole
    batch), which the MoE block reads so as not to split them again."""

    def __init__(self, tree, specs, mesh, *, row_axes: Tuple[str, ...] = (),
                 layer: Optional[int] = None, _unbound=None):
        self._tree, self._specs, self.mesh = tree, specs, mesh
        self.row_axes = tuple(row_axes)
        self._layer = layer
        self._cache: Dict[str, torch.Tensor] = {}
        self._unbound = {} if _unbound is None else _unbound

    def __iter__(self) -> Iterator[str]:
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)

    def __contains__(self, key) -> bool:
        return key in self._tree

    def shard(self, key: str) -> torch.Tensor:
        """The raw shard of leaf ``key`` (this layer's slice in a layer
        view, which needs an unsharded layer dim)."""
        x, s = self._tree[key], self._specs[key]
        if self._layer is None:
            return x
        if s[0] is not None:
            raise ValueError(f"{key}: the layer dim is sharded ({s})")
        if key not in self._unbound:
            # unbind once: its backward stacks the layers' gradients in
            # one op, where indexing would zero-fill a stack per layer
            self._unbound[key] = x.unbind(0)
        return self._unbound[key][self._layer]

    def spec(self, key: str) -> Tuple:
        s = self._specs[key]
        return s if self._layer is None else s[1:]

    def layer(self, i: int) -> "Gathered":
        return Gathered(self._tree, self._specs, self.mesh,
                        row_axes=self.row_axes, layer=i,
                        _unbound=self._unbound)

    def __getitem__(self, key: str):
        x, s = self._tree[key], self._specs[key]
        if isinstance(x, dict):
            return Gathered(x, s, self.mesh, row_axes=self.row_axes)
        if self._layer is not None:
            if s[0] is None:
                return gather_leaf(self.shard(key), s[1:], self.mesh)
            return gather_leaf(x, s, self.mesh)[self._layer]
        if key not in self._cache:
            self._cache[key] = gather_leaf(x, s, self.mesh)
        return self._cache[key]


# --------------------------------------------------------------------------
# the MoE's expert gathers and the expert-parallel collectives
# --------------------------------------------------------------------------

def _a2a_split_concat(t, split_dim: int, cat_dim: int, axes, mesh):
    parts = list(t.chunk(mesh.axis_size(axes), dim=split_dim))
    return torch.cat(dctx.all_to_all(parts, axes, mesh), dim=cat_dim)


class _GatherExperts(torch.autograd.Function):
    """Forward: (1) an expert dim sharded over ``"data"`` is gathered; (2)
    a ``"model"``-sharded dim is traded for the rank's own expert block
    (an all-to-all over ``"model"``: experts split, that dim joined), or,
    without one, the rank's block is sliced; (3) the other ``"data"``
    dim is gathered.  Backward runs the transposes in reverse: a sum over
    ``"data"`` and a slice, the inverse all-to-all (or a placement and a
    sum over ``"model"``), and a sum and slice for (1)."""

    @staticmethod
    def forward(ctx, shard, spec, mesh, e_loc, tp_ax):
        spec = list(spec)
        ctx.mesh, ctx.e_loc, ctx.tp_ax = mesh, e_loc, tp_ax
        ctx.e_data = spec[0] == "data"
        t = shard
        if ctx.e_data:
            t = dctx.all_gather(t, "data", dim=0, mesh=mesh)
            spec[0] = None
        ctx.n_experts = t.shape[0]
        ctx.m = spec.index(tp_ax) if tp_ax in spec else -1
        if ctx.m > 0:
            t = _a2a_split_concat(t, 0, ctx.m, tp_ax, mesh)
        elif ctx.m < 0:
            e0 = (mesh.index(tp_ax) if tp_ax else 0) * e_loc
            t = t[e0:e0 + e_loc]
        ctx.k = spec.index("data") if "data" in spec else -1
        if ctx.k > 0:
            t = dctx.all_gather(t.contiguous(), "data", dim=ctx.k, mesh=mesh)
        return t.contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous()
        if ctx.k > 0:
            g = dctx.all_reduce(g.clone(), "data", "sum", mesh)
            start, n = _block(mesh, "data", g.shape[ctx.k])
            g = g.narrow(ctx.k, start, n).contiguous()
        if ctx.m > 0:
            g = _a2a_split_concat(g, ctx.m, 0, ctx.tp_ax, mesh)
        elif ctx.m < 0:
            full = g.new_zeros((ctx.n_experts,) + tuple(g.shape[1:]))
            e0 = (mesh.index(ctx.tp_ax) if ctx.tp_ax else 0) * ctx.e_loc
            full[e0:e0 + ctx.e_loc] = g
            g = (dctx.all_reduce(full, ctx.tp_ax, "sum", mesh)
                 if ctx.tp_ax else full)
        if ctx.e_data:
            g = dctx.all_reduce(g.contiguous().clone(), "data", "sum", mesh)
            start, n = _block(mesh, "data", g.shape[0])
            g = g.narrow(0, start, n).contiguous()
        return g, None, None, None, None


def gather_experts(shard: torch.Tensor, spec: Sequence, mesh, e_loc: int,
                   tp_ax: Optional[str]) -> torch.Tensor:
    """This rank's ``e_loc`` experts of one layer's expert leaf, whole on
    every other dim: experts ``index(tp_ax) * e_loc`` on, from a shard of
    the (E, ...) leaf under ``spec`` (whose entries are ``None``,
    ``"data"`` or ``tp_ax``).  No rank ever holds all E experts whole."""
    if any(e not in (None, "data", tp_ax) for e in spec):
        raise ValueError(f"expert spec {tuple(spec)} on axes other than "
                         f"data and {tp_ax}")
    return _GatherExperts.apply(shard, tuple(spec), mesh, e_loc, tp_ax)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return dctx.all_reduce(x.contiguous().clone(), axes, "sum", mesh)

    @staticmethod
    def backward(ctx, g):
        return dctx.all_reduce(g.contiguous().clone(), ctx.axes, "sum",
                               ctx.mesh), None, None


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``x`` summed over this rank's slice along ``axes`` (a new tensor;
    the reference's ``psum``): each rank's result feeds its own loss
    contribution, so the transpose sums the gradients alike."""
    mesh = mesh or dctx.current_mesh()
    if mesh.group(axes) is None:
        return x
    return _Psum.apply(x, axes, mesh)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh, ctx.n = axes, mesh, x.shape[0]
        return dctx.all_gather(x.contiguous(), axes, dim=0, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        g = dctx.all_reduce(g.contiguous().clone(), ctx.axes, "sum",
                            ctx.mesh)
        i = ctx.mesh.index(ctx.axes)
        return g[i * ctx.n:(i + 1) * ctx.n].contiguous(), None, None


def gather_rows(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """Every rank's rows of its slice along ``axes``, concatenated in slice
    order (the reference's tiled ``all_gather``); the transpose is a
    reduce-scatter (an all-reduce and a slice, on gloo)."""
    mesh = mesh or dctx.current_mesh()
    if mesh.group(axes) is None:
        return x
    return _GatherRows.apply(x, axes, mesh)
