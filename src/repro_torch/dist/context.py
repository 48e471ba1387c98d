"""The active mesh, and the collectives the model stack runs over it.

The model stack never receives a mesh argument; it asks this module.  A
``use_mesh`` block pushes ``(mesh, dp_axes, tp_axis)`` onto a
thread-local stack; everything sharding-related resolves against the top
of that stack and degrades to a no-op when it is empty.  The axis rules
are the reference's (``repro.dist``): ``"pod"`` and ``"data"`` are
data-parallel, ``"model"`` is the tensor- and expert-parallel axis, and
``use_mesh(mesh, dp_axes=...)`` can claim any axis as data-parallel.

The port's mesh is SPMD over processes, not one controller over devices:
a :class:`Mesh` names a grid over the ranks of an initialised
``torch.distributed`` world, and every rank runs the same program.  A
served model's ranks hold the whole (replicated) parameter tree and
replicated activations, and a sharded op takes its rank's tile as a slice
at the call and meets the other ranks in an explicit collective
(:func:`all_gather`, :func:`all_reduce`).  The sharded trainer keeps each
rank's ZeRO-3 shard of the tree instead (``dist.zero``) and its rows of
the batch (``launch.train``).  So :func:`shard` and
:func:`shard_batch_dim`, which in the reference place a sharding
constraint for GSPMD, are the identity here: there is no compiler to
constrain, and every layout is explicit.  Every rank must run the same
sequence of collectives, so a host decision that reads a clock is made
once and broadcast (:func:`broadcast_float`).

The collectives hand ``torch.distributed`` the tensor on its own device;
the backend (gloo on one card, where two ranks share the device) moves it
through host memory itself.  :data:`counts` tallies each collective's
calls, bytes and host seconds, which is how a step's collective time is
read.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["Mesh", "use_mesh", "current_mesh", "mesh_axes", "dp_axes",
           "tp_axis", "pspec_for", "shard", "shard_batch_dim", "all_gather",
           "all_reduce", "broadcast_float", "counts", "TP_AXIS"]

TP_AXIS = "model"

# One spec entry: None (replicated), an axis name, or a tuple of axis names.
AxisEntry = Union[None, str, Sequence[str]]


class Mesh:
    """A named grid over the ranks of the initialised default group.

    Ranks lie rank-major: the last axis varies fastest, so with the
    ``"model"`` axis last the ranks of one model group are neighbours, as
    ``make_host_mesh`` lays devices out in the reference.  One process
    group is made for every slice of every non-empty set of axes (a slice
    fixes the other axes' coordinates), by ``dist.new_group`` on every rank
    in the same order, once, here.  A group's ranks are in increasing
    order, which is the row-major order of the slice's coordinates: the
    order in which the reference's ``shard_map`` tiles a dim over those
    axes.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                             f"{tuple(axis_names)}")
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised torch.distributed"
                               " process group")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"mesh {self.shape} has {self.size} ranks; the "
                             f"world has {world}")
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names, self._unravel(self.rank)))
        # host-side values (a clock reading, trial times) travel on the
        # backend's own device: the CPU for gloo, the card for nccl
        self.comm_device = (
            torch.device("cpu") if dist.get_backend() == "gloo"
            else torch.device("cuda", torch.cuda.current_device()))
        self._groups: Dict[Tuple[str, ...], object] = {}
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                for ranks in self._slices(axes):
                    if len(ranks) < 2:
                        continue  # a one-rank slice needs no group
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def _unravel(self, rank: int) -> List[int]:
        out = []
        for s in reversed(list(self.shape.values())):
            out.append(rank % s)
            rank //= s
        return out[::-1]

    def _ravel(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _slices(self, axes: Tuple[str, ...]) -> List[List[int]]:
        """Every slice along ``axes``: its ranks in increasing order."""
        others = [a for a in self.axis_names if a not in axes]
        out = []
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            base = dict(zip(others, fixed))
            ranks = []
            for var in itertools.product(*(range(self.shape[a])
                                           for a in axes)):
                ranks.append(self._ravel({**base, **dict(zip(axes, var))}))
            out.append(sorted(ranks))
        return out

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        """Ranks in one slice along ``axes`` (an axis name or a tuple)."""
        return math.prod(self.shape[a] for a in self._key(axes))

    def index(self, axes) -> int:
        """This rank's position in its slice along ``axes``: the row-major
        index of its coordinates on those axes."""
        i = 0
        for a in self._key(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of this rank's slice along ``axes``, or None
        when the slice is this rank alone."""
        return self._groups.get(self._key(axes))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


class _Stack(threading.local):
    def __init__(self):
        self.frames = []  # [(mesh, dp_axes: tuple, tp_axis: str | None)]


_stack = _Stack()


def _resolve_axes(mesh, dp_override: Optional[Sequence[str]] = None
                  ) -> Tuple[Tuple[str, ...], Optional[str]]:
    """Split mesh axes into (data-parallel tuple, tensor-parallel axis)."""
    names = tuple(mesh.axis_names)
    if dp_override is None:
        dp = tuple(a for a in names if a != TP_AXIS)
        tp = TP_AXIS if TP_AXIS in names else None
    else:
        unknown = set(dp_override) - set(names)
        if unknown:
            raise ValueError(f"dp_axes {sorted(unknown)} not in mesh axes "
                             f"{names}")
        dp = tuple(a for a in names if a in dp_override)
        tp = TP_AXIS if TP_AXIS in names and TP_AXIS not in dp else None
    return dp, tp


@contextlib.contextmanager
def use_mesh(mesh, *, dp_axes: Optional[Sequence[str]] = None):
    """Make ``mesh`` the active mesh for the enclosed block (re-entrant;
    the outer mesh comes back on exit, an exception included).

    ``dp_axes`` overrides which axes count as data-parallel; by default all
    axes except ``"model"``.  Passing every axis leaves ``tp_axis() is
    None``: every linear is then single-rank ``quant``."""
    frame = (mesh,) + _resolve_axes(mesh, dp_axes)
    _stack.frames.append(frame)
    try:
        yield mesh
    finally:
        _stack.frames.pop()


def current_mesh():
    """The innermost ``use_mesh`` mesh, or None outside any."""
    return _stack.frames[-1][0] if _stack.frames else None


def mesh_axes(mesh=None) -> Tuple[Tuple[str, ...], Optional[str]]:
    """(dp_axes, tp_axis) for ``mesh`` (default: the active mesh).

    For the active mesh this honours the ``use_mesh(dp_axes=...)`` override;
    for any other mesh it applies the default split."""
    if _stack.frames and (mesh is None or mesh is _stack.frames[-1][0]):
        return _stack.frames[-1][1], _stack.frames[-1][2]
    if mesh is None:
        return (), None
    return _resolve_axes(mesh)


def dp_axes() -> Tuple[str, ...]:
    """Data-parallel axis names of the active mesh (``()`` outside one)."""
    return _stack.frames[-1][1] if _stack.frames else ()


def tp_axis() -> Optional[str]:
    """Tensor-parallel axis name of the active mesh, or None."""
    return _stack.frames[-1][2] if _stack.frames else None


def _normalize_entry(mesh, dim_size: int, entry: AxisEntry):
    """Drop axes that are absent or do not divide ``dim_size``."""
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    axes = tuple(a for a in axes if a in mesh.axis_names
                 and mesh.shape[a] > 1)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    if not axes or dim_size % size:
        return None
    return axes[0] if len(axes) == 1 else axes


def pspec_for(mesh, shape: Sequence[int], *entries: AxisEntry
              ) -> Tuple[AxisEntry, ...]:
    """A spec for ``shape`` keeping only valid, dividing entries (missing
    trailing entries replicate)."""
    if len(entries) > len(shape):
        raise ValueError(f"{len(entries)} spec entries for rank-{len(shape)} "
                         f"array")
    return tuple(_normalize_entry(mesh, d, e) for d, e in zip(
        shape, tuple(entries) + (None,) * (len(shape) - len(entries))))


def shard(x, *entries: AxisEntry):
    """The identity.  In the reference this constrains ``x``'s sharding
    for GSPMD; the port's tensors are replicated on every rank and a
    sharded op slices its tile at the call, so there is nothing to
    constrain."""
    return x


def shard_batch_dim(x, dim: int = 0):
    """The identity, as :func:`shard`."""
    return x


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

# per collective kind: calls, bytes, host seconds.  The bytes are the
# rank's input, or, for a floating-point sum (an all-gather, see
# all_reduce), the world's copies of it that land on the rank
counts: Dict[str, Dict[str, float]] = {}


def _tally(kind: str, nbytes: int, t0: float) -> None:
    c = counts.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    c["calls"] += 1
    c["bytes"] += nbytes
    c["seconds"] += time.perf_counter() - t0


def all_gather(x: torch.Tensor, axes, dim: int = 0,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's ``x`` of this rank's slice along ``axes``,
    concatenated along ``dim`` in the slice's rank order (the reference's
    tiled ``all_gather``).  ``x`` itself when the slice is one rank."""
    mesh = mesh or current_mesh()
    g = mesh.group(axes)
    if g is None:
        return x
    t0 = time.perf_counter()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axes))]
    dist.all_gather(parts, x, group=g)
    out = torch.cat(parts, dim=dim)
    _tally("all_gather", x.numel() * x.element_size(), t0)
    return out


def all_reduce(x: torch.Tensor, axes, op: str = "sum",
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over this rank's slice along
    ``axes``, in place, and returned.  An integer sum is exact; a max is
    exact in any dtype.  A floating-point sum gathers every rank's ``x``
    and adds them in the slice's order, so every rank gets the same bits:
    gloo's all-reduce may round a sum of more than two ranks differently
    on different ranks, and replicated state must not drift apart."""
    mesh = mesh or current_mesh()
    g = mesh.group(axes)
    if g is None:
        return x
    t0 = time.perf_counter()
    if op == "sum" and x.is_floating_point():
        parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axes))]
        dist.all_gather(parts, x.contiguous(), group=g)
        x.copy_(torch.stack(parts).sum(0))
        nbytes = len(parts) * x.numel() * x.element_size()
    else:
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=g)
        nbytes = x.numel() * x.element_size()
    _tally(f"all_reduce_{op}", nbytes, t0)
    return x


def broadcast_float(value: float, mesh: Optional[Mesh] = None) -> float:
    """Rank 0's ``value`` (float64) on every rank of ``mesh``: how a host
    decision that reads a clock is made once."""
    mesh = mesh or current_mesh()
    t = torch.tensor([value], dtype=torch.float64, device=mesh.comm_device)
    if mesh.size > 1:
        t0 = time.perf_counter()
        dist.broadcast(t, src=0)
        _tally("broadcast", 8, t0)
    return float(t[0])
