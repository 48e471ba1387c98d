"""Host-side schedule of crossbar microcode into groups of independent gates.

A dot program's microcode is one long list of gates, but most neighbouring
gates do not depend on each other: the gates of one operation work on
disjoint partitions of the crossbar (``core/program.py::to_microcode``), and
many operations touch disjoint columns too.  This pass assigns every row to
a *group* of at most ``width`` gates that are independent: no gate of a
group writes a column that another gate of the group reads or writes (a
gate may read its own destination).  Executing the groups in order, the
gates of each in any order or all at once, then gives the state that
sequential execution gives.  The CUDA kernel relies on that: it splits
each group's gates across warps and puts a barrier only between groups.

The pass is full dependency levelling with packing: each row, in program
order, goes to the first group after every group holding a gate it depends
on (one that writes a column it reads or writes, or reads a column it
writes) that still has room (first fit).  On the 37-term dot program
(86,320 rows) the uncapped levels number 3,792 (3,437 if a read and a
later write of one column could share a level); with ``width`` 24 the
groups number 3,985 with 9.7 % padding, where splitting each level into
groups of 24 would give 5,626 with 36 % padding.  Inside a group, rows keep
program order.

Read sets follow the microcode ABI: INIT (code 0) reads nothing, NOT
(code 1) reads only ``ia`` (its ``ib`` may be junk), codes 2..5 read
``ia`` and ``ib``.

Groups have a fixed width: a group short of ``width`` gates is padded with
no-op rows ``(AND, n, n, n)`` on an extra all-zero column ``n`` that the
executors add past the state's ``n`` columns and never write back.
:func:`decode` turns rows into the form the kernel runs: every gate as
``((a & b) | ((a | b) & orm)) ^ inv`` over columns ``a`` and ``b``, with
INIT as NOR of the zero column with itself and NOT as NOR of ``ia`` with
itself; :func:`pack` lays the decoded groups out as the kernel's records.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["GROUP_WIDTH", "KERNEL_WARPS", "schedule", "decode", "pack"]

# the CUDA kernel's GROUP and WARPS: each of its warps runs GROUP_WIDTH /
# KERNEL_WARPS gates of every group
GROUP_WIDTH = 24
KERNEL_WARPS = 4

_READS_B = np.array([False, False, True, True, True, True])


def _assign_groups(mc: np.ndarray, n: int, width: int) -> np.ndarray:
    """Group index of every row (first fit under the dependencies)."""
    last_w = [-1] * (n + 1)   # group of the latest writer of each column
    last_r = [-1] * (n + 1)   # latest group reading it since that write
    fill: List[int] = []      # rows placed in each group
    nxt: List[int] = []       # union-find: nxt[h] == h while h has room
    out = np.empty(len(mc), np.int64)

    def first_open(h: int) -> int:
        root = h
        while root < len(nxt) and nxt[root] != root:
            root = nxt[root]
        while h < len(nxt) and nxt[h] != h:
            nxt[h], h = root, nxt[h]
        return root

    for i, (code, ia, ib, dst) in enumerate(mc.tolist()):
        reads = () if code == 0 else (ia,) if code == 1 else (ia, ib)
        lo = max(last_w[dst], last_r[dst]) + 1
        for c in reads:
            lo = max(lo, last_w[c] + 1)
        h = first_open(lo)
        if h == len(fill):
            fill.append(0)
            nxt.append(h)
        out[i] = h
        fill[h] += 1
        if fill[h] == width:
            nxt[h] = h + 1
        for c in reads:
            last_r[c] = max(last_r[c], h)
        last_w[dst] = h
        last_r[dst] = -1
    return out


def schedule(microcode: np.ndarray, n: int, width: int = GROUP_WIDTH
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Group ``(G, 4)`` microcode over ``n`` columns -> ``(rows, offsets)``.

    ``rows`` holds every microcode row once, in group order and program
    order within a group, each group padded to ``width`` rows with no-op
    rows ``(5, n, n, n)``; group ``g`` is ``rows[offsets[g]:offsets[g+1]]``.
    """
    mc = np.asarray(microcode, np.int32).reshape(-1, 4)
    if width < 1:
        raise ValueError(f"group width must be positive, got {width}")
    if len(mc) == 0:
        return np.zeros((0, 4), np.int32), np.zeros(1, np.int64)
    grp = _assign_groups(mc, n, width)
    n_groups = int(grp.max()) + 1
    order = np.argsort(grp, kind="stable")           # program order inside
    slot = np.arange(len(mc)) - np.searchsorted(grp[order], grp[order])
    rows = np.empty((n_groups * width, 4), np.int32)
    rows[:] = (5, n, n, n)
    rows[grp[order] * width + slot] = mc[order]
    return rows, np.arange(0, len(rows) + 1, width, dtype=np.int64)


def decode(rows: np.ndarray, n: int) -> Tuple[np.ndarray, ...]:
    """Rows -> ``(a, b, dst, orm, inv)`` int32 arrays: the gate is
    ``((s[a] & s[b]) | ((s[a] | s[b]) & orm)) ^ inv`` into ``s[dst]``,
    where column ``n`` is all zeros."""
    rows = np.asarray(rows, np.int32).reshape(-1, 4)
    code, ia, ib, dst = rows.T
    a = np.where(code == 0, n, ia)
    b = np.where(code == 0, n, np.where(_READS_B[code], ib, ia))
    orm = np.where(code <= 3, -1, 0)       # INIT, NOT, NOR, OR
    inv = np.where((code <= 2) | (code == 4), -1, 0)   # + NAND
    return tuple(v.astype(np.int32) for v in (a, b, dst, orm, inv))


def pack(rows: np.ndarray, n: int) -> np.ndarray:
    """The kernel's group records, ``(groups, KERNEL_WARPS, 2, per_warp)``
    int32 with ``per_warp = GROUP_WIDTH // KERNEL_WARPS``: per group and
    warp, for each of the warp's gates the word ``a | b << 16``, then for
    each the word ``dst | orm << 30 | inv << 31`` with one bit per mask
    (see :func:`decode`), groups as :func:`schedule` gives them.  Columns
    take 16 bits: ``n`` < 65536."""
    if len(rows) % GROUP_WIDTH:
        raise ValueError(f"{len(rows)} rows are not whole groups of "
                         f"{GROUP_WIDTH}")
    if n >= 1 << 16:
        raise ValueError(f"the kernel's records hold 16-bit columns; n={n}")
    a, b, dst, orm, inv = (v.astype(np.uint32) for v in decode(rows, n))
    words = np.stack([a | b << 16, dst | (orm & 1) << 30 | (inv & 1) << 31])
    return np.ascontiguousarray(
        words.view(np.int32)
        .reshape(2, -1, KERNEL_WARPS, GROUP_WIDTH // KERNEL_WARPS)
        .transpose(1, 2, 0, 3))
