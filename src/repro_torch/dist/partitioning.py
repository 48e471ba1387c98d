"""The tensor-parallel dim rule, shared by the tile split and (later) the
sharded weight layout.

The reference's ``param_pspecs`` puts the largest dim of a weight that
the ``"model"`` axis divides on that axis (ties to the later dim: column
parallel for a square weight), and ``quant_tp`` splits each linear's tile
on the same dim, so a weight's tile is where its shard would live.  The
port keeps the rule; its sharding-spec factories (``param_pspecs``,
``opt_state_pspecs``, ``batch_pspecs``, ``cache_pspecs``,
``tree_shardings``) and ``replica_slices`` wait for the sharded trainer
and the router (ROADMAP.md, items D and E).
"""
from __future__ import annotations

__all__ = ["tp_shard_dim"]


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
