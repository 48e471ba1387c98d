"""Sharding-spec factories for the trainer, and the fleet's replica slices.

A spec is a tuple with one axis entry per dim of a leaf: ``None``
(replicated), an axis name, or a tuple of axis names, as
``context._normalize_entry`` takes them; ``()`` is a scalar's.  The
reference's ``PartitionSpec`` of the same leaf, read as a tuple, is the
same tuple.  The factories are **shape-driven**: they walk trees whose
leaves have a ``.shape`` (tensors), are the port's
``(shape, dtype, init, scale)`` parameter specs, or are plain shape
tuples, and read only ``mesh.shape`` and ``mesh.axis_names``, so any
object with those two attributes will do for a mesh.

Placement rules (the reference's, ``repro.dist.partitioning``):

* **params** — the largest dim divisible by the ``"model"`` axis is
  tensor-parallel (ties pick the later dim: column-parallel for square
  ``(d, ff)`` weights); with ``fsdp=True`` the largest *remaining* dim
  divisible by ``"data"`` is ZeRO-3 sharded (ties pick the earlier dim).
* **optimizer state** — mirrors the param spec; Adafactor row/col
  statistics inherit the surviving dims of their param's spec.
* **batches** — leading (batch) dim over the data-parallel axes, dropped
  when the global batch does not divide.

``dist.zero`` keeps a rank's shard of a leaf under its spec and gathers it
back; ``quant_tp`` splits its tiles with :func:`tp_shard_dim`, the rule
``param_pspecs`` puts on ``"model"``.  :func:`cache_pspecs` lays out
decode caches, and :func:`tree_shardings` turns a spec tree into
:class:`TensorSharding` leaves, whose ``shard_shape`` is the reference's
``NamedSharding.shard_shape``: the dry run sums a rank's argument bytes
from them (``launch.dryrun``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.dist import context as dctx
from repro_torch.tree import leaves, rebuild

__all__ = ["param_pspecs", "opt_state_pspecs", "batch_pspecs",
           "cache_pspecs", "tp_shard_dim", "replica_slices", "leaf_shape",
           "TensorSharding", "tree_shardings"]

FSDP_AXIS = "data"


def _axis_size(mesh, axis: Optional[str]) -> int:
    return mesh.shape[axis] if axis and axis in mesh.axis_names else 1


def leaf_shape(x) -> Tuple[int, ...]:
    """The shape of a tree leaf: a tensor's ``.shape``, the first field of
    a ``(shape, dtype, init, scale)`` parameter spec, or a shape tuple."""
    if hasattr(x, "shape"):
        return tuple(int(d) for d in x.shape)
    if isinstance(x, tuple) and x and isinstance(x[0], tuple):
        return tuple(int(d) for d in x[0])
    return tuple(int(d) for d in x)


def _pick_dim(shape, divisor: int, taken, *, prefer_late: bool) -> int:
    """Index of the largest dim divisible by ``divisor`` (excluding
    ``taken``), or -1.  Ties resolve to the later/earlier dim."""
    best, best_size = -1, 0
    dims = range(len(shape))
    for i in (reversed(dims) if prefer_late else dims):
        if i in taken or shape[i] % divisor or shape[i] < divisor:
            continue
        if shape[i] > best_size:
            best, best_size = i, shape[i]
    return best


def tp_shard_dim(shape, tp_size: int) -> int:
    """The dim index the ``"model"`` axis shards, or -1: the largest dim
    divisible by ``tp_size``, ties to the *later* dim (column-parallel for
    square weights).  ``kernels.quant_matmul.tp`` splits its tiles on it."""
    return _pick_dim(shape, tp_size, set(), prefer_late=True)


def _param_spec(shape, mesh, tp_ax: Optional[str], fsdp_ax: Optional[str]
                ) -> Tuple:
    entries = [None] * len(shape)
    taken = set()
    tp_size = _axis_size(mesh, tp_ax)
    if tp_size > 1:
        i = tp_shard_dim(shape, tp_size)
        if i >= 0:
            entries[i] = tp_ax
            taken.add(i)
    fsdp_size = _axis_size(mesh, fsdp_ax)
    if fsdp_size > 1:
        i = _pick_dim(shape, fsdp_size, taken, prefer_late=False)
        if i >= 0:
            entries[i] = fsdp_ax
            taken.add(i)
    return tuple(entries)


def param_pspecs(pshapes, mesh, *, fsdp: bool = False, tp: bool = True):
    """Spec tree for a param tree.  ``tp=False`` keeps weights off the
    ``"model"`` axis (dp-only policy); ``fsdp=True`` additionally shards
    over ``"data"`` (ZeRO-3)."""
    _, tp_ax = dctx.mesh_axes(mesh)
    tp_ax = tp_ax if tp else None
    fsdp_ax = FSDP_AXIS if fsdp else None
    return rebuild(pshapes, (_param_spec(leaf_shape(s), mesh, tp_ax, fsdp_ax)
                             for _, s in leaves(pshapes)))


def opt_state_pspecs(pshapes, param_part, opt_state, mesh):
    """Specs for ``optim.adamw`` state: moments mirror their param's spec;
    factored row/col stats keep the spec entries of their surviving dims;
    the step counter replicates (``()``)."""
    del mesh  # the reference's signature; the specs carry the axes
    specs = [sp for _, sp in leaves(param_part)]
    states = [_at(opt_state["leaves"], path) for path, _ in leaves(pshapes)]

    def leaf(spec: Tuple, st: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"m": spec}
        if "v" in st:
            out["v"] = spec
        else:  # Adafactor: vr = shape[:-1], vc = shape[:-2] + shape[-1:]
            out["vr"] = spec[:-1]
            out["vc"] = spec[:-2] + spec[-1:]
        return out

    return {"step": (),
            "leaves": rebuild(pshapes, (leaf(sp, st) for sp, st
                                        in zip(specs, states)))}


def batch_pspecs(batch, mesh):
    """Input batches: leading dim over the data-parallel axes (dropped when
    the global batch does not divide), everything else replicated."""
    dp, _ = dctx.mesh_axes(mesh)
    return rebuild(batch, (dctx.pspec_for(mesh, leaf_shape(s), dp)
                           for _, s in leaves(batch)))


def cache_pspecs(caches, mesh, *, batch_over_dp: bool = True):
    """Decode caches ``(n_super, batch, ...)``: batch dim over the DP
    axes, the head dim (-2) of rank>=4 leaves over the "model" axis.

    ``batch_over_dp=False`` keeps the batch (slot) dim replicated while
    heads still ride "model" — the serving pool's placement, and the
    block-paged pool's, whose dim 1 is the block dim.  Quantized-KV
    *scale* leaves (``k_scale``/``v_scale``) are the KV leaf minus its
    trailing head-dim axis, so their head dim is last: they get "model"
    on ``-1``.  The reference's rules, leaf for leaf."""
    dp, tp_ax = dctx.mesh_axes(mesh)

    def leaf(path, s):
        shape = leaf_shape(s)
        nd = len(shape)
        entries = [None] * nd
        if nd >= 2 and batch_over_dp:
            entries[1] = dp
        if nd >= 4 and tp_ax:
            name = path[-1] if path else ""
            entries[-1 if name.endswith("_scale") else -2] = tp_ax
        return dctx.pspec_for(mesh, shape, *entries)

    return rebuild(caches, (leaf(p, s) for p, s in leaves(caches)))


class TensorSharding:
    """A spec on a mesh (the reference's ``NamedSharding``): ``spec`` has
    one entry per dim, as the factories above make them."""

    def __init__(self, mesh, spec: Tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one rank's shard of a leaf of ``shape``: each dim
        divided by the ranks of its entry's axes (it must divide)."""
        shape = tuple(int(d) for d in shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} for shape {shape}")
        out = []
        for d, entry in zip(shape, self.spec + (None,) * (len(shape)
                                                          - len(self.spec))):
            n = 1 if entry is None else self.mesh.axis_size(entry)
            if d % n:
                raise ValueError(f"dim {d} of {shape} does not split over "
                                 f"{entry} = {n}")
            out.append(d // n)
        return tuple(out)

    def __repr__(self) -> str:
        return f"TensorSharding({self.spec})"


def tree_shardings(spec_tree, mesh):
    """Spec tree -> :class:`TensorSharding` tree on ``mesh``."""
    return rebuild(spec_tree, (TensorSharding(mesh, sp)
                               for _, sp in leaves(spec_tree)))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def replica_slices(n_replicas: int, devices: Sequence):
    """Disjoint contiguous slices of ``devices`` for a data-parallel
    replica fleet.

    The serving router over ranks gives each replica its own slice of the
    world's ranks (its own sub-mesh); contiguity keeps each replica's
    model-parallel neighbours together, as ``ElasticMesh.make`` lays
    ranks out.  ``n_replicas`` must divide the count: a ragged fleet would
    hand replicas unequal capacity.  Any sequence splits (the reference's
    default, every device of the process, has no counterpart in a world
    of processes)."""
    devices = list(devices)
    n = len(devices)
    if n_replicas < 1 or n % n_replicas:
        raise ValueError(
            f"{n_replicas} replicas cannot evenly split {n} devices")
    per = n // n_replicas
    return [devices[i * per:(i + 1) * per] for i in range(n_replicas)]
