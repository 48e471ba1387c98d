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

A mesh may lie over a subset of the world (``Mesh(shape, axes, ranks)``):
a serving replica's sub-mesh (``serving.router``).  ``dist.new_group`` is
collective over the whole world, so every rank builds every sub-mesh, in
the same order, even one it is not in (its ``member`` is then false).

A :class:`VirtualMesh` has the same interface and no process group: it
is one rank of a mesh of any size, for the dry run (``launch.dryrun``).
Under it the collectives move nothing; they return what the rank would
receive (the right shapes, on the input's device, fake tensors included)
and :func:`record_collectives` lists each call's kind, result bytes and
group.
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

__all__ = ["Mesh", "VirtualMesh", "use_mesh", "current_mesh", "mesh_axes",
           "dp_axes", "tp_axis", "pspec_for", "shard", "shard_batch_dim",
           "all_gather", "all_reduce", "all_to_all", "broadcast_float",
           "broadcast_object", "gather_objects", "record_collectives",
           "counts", "TP_AXIS"]

TP_AXIS = "model"

# One spec entry: None (replicated), an axis name, or a tuple of axis names.
AxisEntry = Union[None, str, Sequence[str]]


class _Grid:
    """The rank-major coordinate arithmetic of a named grid over
    ``self.ranks`` (world ranks; position ``i`` has the coordinates of
    row-major index ``i``), shared by :class:`Mesh` and
    :class:`VirtualMesh`."""

    def _init_grid(self, shape, axis_names, ranks, me):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.ranks = tuple(int(r) for r in ranks)
        if len(self.ranks) != self.size or len(set(self.ranks)) != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} distinct "
                             f"ranks, got {list(self.ranks)}")
        self.rank = me
        self.member = me in self.ranks
        self.coords = (dict(zip(self.axis_names, self._unravel(
            self.ranks.index(me)))) if self.member else None)

    def _unravel(self, i: int) -> List[int]:
        out = []
        for s in reversed(list(self.shape.values())):
            out.append(i % s)
            i //= s
        return out[::-1]

    def _ravel(self, coords: Dict[str, int]) -> int:
        i = 0
        for a in self.axis_names:
            i = i * self.shape[a] + coords[a]
        return i

    def _slices(self, axes: Tuple[str, ...]) -> List[List[int]]:
        """Every slice along ``axes``: its world ranks in increasing
        order."""
        others = [a for a in self.axis_names if a not in axes]
        out = []
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            base = dict(zip(others, fixed))
            ranks = []
            for var in itertools.product(*(range(self.shape[a])
                                           for a in axes)):
                ranks.append(self.ranks[self._ravel(
                    {**base, **dict(zip(axes, var))})])
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
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in {self!r}")
        i = 0
        for a in self._key(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def slice_ranks(self, axes) -> List[int]:
        """The world ranks of this rank's slice along ``axes``, in
        increasing order."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in {self!r}")
        key = self._key(axes)
        return sorted(self.ranks[self._ravel(
            {**self.coords, **dict(zip(key, var))})]
            for var in itertools.product(*(range(self.shape[a])
                                           for a in key)))

    def group(self, axes):
        """The process group of this rank's slice along ``axes``, or None
        when the slice is this rank alone (or the rank is not a
        member)."""
        return self._groups.get(self._key(axes))


class Mesh(_Grid):
    """A named grid over ranks of the initialised default group: the whole
    world (``ranks=None``) or the listed world ranks.

    Ranks lie rank-major: the last axis varies fastest, so with the
    ``"model"`` axis last the ranks of one model group are neighbours, as
    ``make_host_mesh`` lays devices out in the reference.  One process
    group is made for every slice of every non-empty set of axes (a slice
    fixes the other axes' coordinates), by ``dist.new_group`` on every
    rank of the world in the same order, once, here: a rank outside
    ``ranks`` builds the mesh too, and gets one whose ``member`` is false
    and that holds no group.  A group's ranks are in increasing order,
    which is the row-major order of the slice's coordinates: the order in
    which the reference's ``shard_map`` tiles a dim over those axes.
    ``rank`` is the world rank; ``ranks[0]`` is the mesh's first rank,
    whose clock and decisions the others take (:func:`broadcast_float`).
    """

    virtual = False

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 ranks: Optional[Sequence[int]] = None):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised torch.distributed"
                               " process group")
        world = dist.get_world_size()
        if ranks is None:
            size = math.prod(int(x) for x in shape)
            if size != world:
                raise ValueError(f"mesh {dict(zip(axis_names, shape))} has "
                                 f"{size} ranks; the world has {world}")
            ranks = range(world)
        bad = [r for r in ranks if not 0 <= int(r) < world]
        if bad:
            raise ValueError(f"ranks {bad} are not in a world of {world}")
        self._init_grid(shape, axis_names, ranks, dist.get_rank())
        # host-side values (a clock reading, trial times) travel on the
        # backend's own device: the CPU for gloo, the card for nccl
        self.comm_device = (
            torch.device("cpu") if dist.get_backend() == "gloo"
            else torch.device("cuda", torch.cuda.current_device()))
        self._groups: Dict[Tuple[str, ...], object] = {}
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                for ranks_ in self._slices(axes):
                    if len(ranks_) < 2:
                        continue  # a one-rank slice needs no group
                    g = dist.new_group(ranks_)
                    if self.rank in ranks_:
                        self._groups[axes] = g

    def __repr__(self) -> str:
        where = (f"rank {self.rank} at {self.coords}" if self.member
                 else f"rank {self.rank} not a member")
        return f"Mesh({self.shape} over {list(self.ranks)}, {where})"


class _VirtualGroup:
    """The stand-in group of a :class:`VirtualMesh` slice: its ranks."""

    def __init__(self, ranks):
        self.ranks = tuple(ranks)

    def size(self) -> int:
        return len(self.ranks)


class VirtualMesh(_Grid):
    """One rank (``rank``, default 0) of a named grid of any size, with no
    process group: the dry run's mesh.  It has :class:`Mesh`'s interface
    (``shape``, ``axis_names``, ``size``, ``rank``, ``coords``,
    ``axis_size``, ``index``, ``group``); under it the collectives of this
    module move nothing and return what the rank would receive."""

    virtual = True

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0):
        self._init_grid(shape, axis_names, range(math.prod(
            int(x) for x in shape)), rank)
        if not self.member:
            raise ValueError(f"rank {rank} is not in a mesh of {self.size}")
        self.comm_device = torch.device("cpu")
        self._groups = {}
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                mine = self.slice_ranks(axes)
                if len(mine) > 1:
                    self._groups[axes] = _VirtualGroup(mine)

    def __repr__(self) -> str:
        return f"VirtualMesh({self.shape}, rank {self.rank} at {self.coords})"


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


class _Record(threading.local):
    def __init__(self):
        self.calls = None  # [(op, result bytes, group ranks)] or None


_record = _Record()


@contextlib.contextmanager
def record_collectives():
    """List every collective this thread runs in the block, on any mesh, as
    ``(op, result_bytes, group_ranks)``: ``op`` in the reference's HLO
    names (``"all-gather"``, ``"all-reduce"``, ``"all-to-all"``),
    ``result_bytes`` the bytes of the result the rank holds (an
    all-gather's whole output), ``group_ranks`` the slice's world ranks.
    The dry run prices these with ``launch.dryrun.collective_mix``."""
    prev, _record.calls = _record.calls, []
    try:
        yield _record.calls
    finally:
        _record.calls = prev


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _tally(kind: str, nbytes: int, t0: float, op: Optional[str] = None,
           result_bytes: int = 0, mesh: Optional[Mesh] = None,
           axes=None) -> None:
    """Count a collective; inside ``record_collectives`` also list it,
    with the world ranks of ``mesh``'s slice along ``axes``."""
    c = counts.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    c["calls"] += 1
    c["bytes"] += nbytes
    c["seconds"] += time.perf_counter() - t0
    if op is not None and _record.calls is not None:
        _record.calls.append((op, int(result_bytes),
                              tuple(mesh.slice_ranks(axes))))


def all_gather(x: torch.Tensor, axes, dim: int = 0,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's ``x`` of this rank's slice along ``axes``,
    concatenated along ``dim`` in the slice's rank order (the reference's
    tiled ``all_gather``).  ``x`` itself when the slice is one rank.
    Under a :class:`VirtualMesh` every part is a copy of ``x``."""
    mesh = mesh or current_mesh()
    g = mesh.group(axes)
    if g is None:
        return x
    t0 = time.perf_counter()
    x = x.contiguous()
    n = mesh.axis_size(axes)
    if mesh.virtual:
        out = torch.cat([x] * n, dim=dim)
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=g)
        out = torch.cat(parts, dim=dim)
    _tally("all_gather", _nbytes(x), t0, "all-gather", _nbytes(out), mesh,
           axes)
    return out


def all_reduce(x: torch.Tensor, axes, op: str = "sum",
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over this rank's slice along
    ``axes``, in place, and returned.  An integer sum is exact; a max is
    exact in any dtype.  A floating-point sum gathers every rank's ``x``
    and adds them in the slice's order, so every rank gets the same bits:
    gloo's all-reduce may round a sum of more than two ranks differently
    on different ranks, and replicated state must not drift apart.  Under
    a :class:`VirtualMesh` ``x`` is returned as it is (and recorded as one
    all-reduce of its bytes)."""
    mesh = mesh or current_mesh()
    g = mesh.group(axes)
    if g is None:
        return x
    t0 = time.perf_counter()
    if mesh.virtual:
        nbytes = _nbytes(x)
    elif op == "sum" and x.is_floating_point():
        parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axes))]
        dist.all_gather(parts, x.contiguous(), group=g)
        x.copy_(torch.stack(parts).sum(0))
        nbytes = len(parts) * _nbytes(x)
    else:
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=g)
        nbytes = _nbytes(x)
    _tally(f"all_reduce_{op}", nbytes, t0, "all-reduce", _nbytes(x), mesh,
           axes)
    return x


def all_to_all(chunks: List[torch.Tensor], axes,
               mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """``chunks[j]`` to rank ``j`` of this rank's slice along ``axes``;
    returns what each rank of the slice sent here, in slice order.  Staged
    through the backend's device (the host for gloo), one ``scatter`` per
    source rank: gloo has no all-to-all on every build.  Under a
    :class:`VirtualMesh` the rank receives copies of its own chunks."""
    mesh = mesh or current_mesh()
    g = mesh.group(axes)
    if g is None:
        return chunks
    t0 = time.perf_counter()
    nbytes = sum(_nbytes(c) for c in chunks)
    ranks = mesh.slice_ranks(axes)
    if mesh.virtual:
        out = [c.clone() for c in chunks]
    else:
        dev = chunks[0].device
        send = [c.contiguous().to(mesh.comm_device) for c in chunks]
        recv = [torch.empty_like(c) for c in send]
        for j, src in enumerate(ranks):
            dist.scatter(recv[j], send if src == mesh.rank else None,
                         src=src, group=g)
        out = [r.to(dev) for r in recv]
    _tally("all_to_all", nbytes, t0, "all-to-all", nbytes, mesh, axes)
    return out


def broadcast_float(value: float, mesh: Optional[Mesh] = None) -> float:
    """The mesh's first rank's ``value`` (float64) on every rank of
    ``mesh``: how a host decision that reads a clock is made once.  Over a
    sub-mesh the broadcast runs in the sub-mesh's own group."""
    mesh = mesh or current_mesh()
    g = mesh.group(mesh.axis_names)
    if g is None or mesh.virtual:
        return float(value)
    t = torch.tensor([value], dtype=torch.float64, device=mesh.comm_device)
    t0 = time.perf_counter()
    dist.broadcast(t, src=mesh.ranks[0], group=g)
    _tally("broadcast", 8, t0)
    return float(t[0])


def _pickled_bytes(obj) -> int:
    import pickle

    return len(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def broadcast_object(obj, src: int = 0):
    """World rank ``src``'s ``obj`` (any picklable value) on every rank of
    the world: one ``broadcast_object_list`` over the default group.  The
    router over ranks sends its round's decisions this way; the tally
    (``"world_broadcast"``) counts the pickled bytes at ``src``."""
    mine = dist.get_rank() == src
    nbytes = _pickled_bytes(obj) if mine else 0
    t0 = time.perf_counter()
    box = [obj if mine else None]
    dist.broadcast_object_list(box, src=src)
    _tally("world_broadcast", nbytes, t0)
    return box[0]


def gather_objects(obj) -> List:
    """Every world rank's ``obj``, in rank order, on every rank: one
    ``all_gather_object`` over the default group (``"world_gather"`` in
    the tally, with this rank's pickled bytes)."""
    nbytes = _pickled_bytes(obj)
    t0 = time.perf_counter()
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    _tally("world_gather", nbytes, t0)
    return out
