"""Operations on a partitioned memristive crossbar (paper §2.1).

A crossbar has ``n`` bitlines divided by ``k-1`` transistors into ``k``
evenly-spaced *partitions* of ``m = n // k`` bitlines.  Setting a subset of
transistors non-conducting dynamically divides the crossbar into *sections*
(disjoint intervals of partitions); each section may execute one stateful
logic gate per cycle.  An :class:`Operation` is the set of gates executed in
one cycle; the paper classifies operations as *serial* (one gate, whole
crossbar one section), *parallel* (one gate per partition) and
*semi-parallel* (anything in between — gates spanning several partitions).

Column indices are absolute in ``[0, n)``.  ``partition(c) = c // m`` and the
*intra-partition index* is ``c % m`` — the quantity shared across decoders in
the standard/minimal models.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = [
    "PartitionConfig",
    "GateOp",
    "InitOp",
    "Operation",
    "LegalityError",
    "gate_interval",
    "op_intervals",
    "tight_selects",
]


class LegalityError(ValueError):
    """Raised when an operation is illegal under a partition model."""


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """Evenly spaced partitions: ``n`` bitlines, ``k`` partitions."""

    n: int = 1024
    k: int = 32

    def __post_init__(self):
        if self.n % self.k != 0:
            raise ValueError(f"n={self.n} must be divisible by k={self.k}")

    @property
    def m(self) -> int:
        """Bitlines per partition."""
        return self.n // self.k

    def partition(self, col: int) -> int:
        if not 0 <= col < self.n:
            raise ValueError(f"column {col} out of range [0,{self.n})")
        return col // self.m

    def intra(self, col: int) -> int:
        return col % self.m

    def col(self, partition: int, intra: int) -> int:
        assert 0 <= partition < self.k and 0 <= intra < self.m
        return partition * self.m + intra

    def scaled(self, *, n: Optional[int] = None,
               k: Optional[int] = None) -> "PartitionConfig":
        """A validated copy at a different geometry (autotune candidates).

        Widening ``n`` at fixed ``k`` grows the per-partition column budget
        ``m`` (more dot terms per row) but also the column-index field in
        every control message; the trade-off is what ``pim.autotune``
        searches over.
        """
        return PartitionConfig(self.n if n is None else n,
                               self.k if k is None else k)


@dataclasses.dataclass(frozen=True)
class GateOp:
    """One stateful-logic gate: ``gate(*inputs) -> output`` (column indices)."""

    gate: str
    inputs: Tuple[int, ...]
    output: int

    def __post_init__(self):
        from repro_torch.core.gates import GATE_DEFS

        g = GATE_DEFS[self.gate]
        if g.n_inputs != len(self.inputs):
            raise ValueError(f"{self.gate} takes {g.n_inputs} inputs")
        if self.output in self.inputs:
            raise ValueError("MAGIC output memristor must differ from inputs")

    @property
    def columns(self) -> Tuple[int, ...]:
        return self.inputs + (self.output,)


@dataclasses.dataclass(frozen=True)
class InitOp:
    """Initialization (SET to logic '1') of a set of columns in one cycle.

    Initialization is a plain memory *write* (no sneak paths: unconditional
    SET of whole columns), so — as in prior simulators — a contiguous column
    range may be initialized in a single cycle.  Two forms exist:

    * ``range``:    absolute columns ``[lo, hi]`` (legal in every model,
                    including the baseline crossbar: it is just a write).
    * ``periodic``: intra-partition range ``[ilo, ihi]`` replicated at
                    partitions ``p_start, p_start+T, ..., p_end`` — the
                    partition-parallel form used by partitioned algorithms.

    This assumption is applied identically to the serial baseline and to all
    partition models, so latency *ratios* are unaffected by it (DESIGN.md §2).
    """

    kind: str  # "range" | "periodic"
    lo: int = 0
    hi: int = 0  # inclusive; intra-partition for "periodic"
    p_start: int = 0
    p_end: int = 0
    period: int = 1

    def columns(self, cfg: PartitionConfig) -> List[int]:
        if self.kind == "range":
            return list(range(self.lo, self.hi + 1))
        cols: List[int] = []
        for p in range(self.p_start, self.p_end + 1, self.period):
            cols.extend(cfg.col(p, i) for i in range(self.lo, self.hi + 1))
        return cols


@dataclasses.dataclass(frozen=True)
class Operation:
    """One crossbar cycle: either a set of concurrent gates or an init.

    All gates in a logic operation share a single gate type (the gate type
    selects the analog voltage configuration V_IN/V_OUT and is conveyed
    out-of-band of the index message, as in the paper's bit counts).
    """

    gates: Tuple[GateOp, ...] = ()
    init: Optional[InitOp] = None
    label: str = ""

    def __post_init__(self):
        if (self.init is None) == (len(self.gates) == 0):
            raise ValueError("operation must be either gates or an init")
        if self.gates:
            types = {g.gate for g in self.gates}
            if len(types) > 1:
                raise LegalityError(
                    f"one gate type per operation (voltage config): {types}"
                )

    @property
    def is_init(self) -> bool:
        return self.init is not None

    @property
    def gate_type(self) -> str:
        return "INIT" if self.is_init else self.gates[0].gate

    def classify(self, cfg: PartitionConfig) -> str:
        """Paper taxonomy: serial / parallel / semi-parallel (§2.1)."""
        if self.is_init:
            return "init"
        if len(self.gates) == 1:
            return "serial"
        ivals = op_intervals(self, cfg)
        if len(ivals) == cfg.k and all(l == r for l, r in ivals):
            return "parallel"
        return "semi-parallel"


def gate_interval(g: GateOp, cfg: PartitionConfig) -> Tuple[int, int]:
    """The (inclusive) partition interval a gate's section must span."""
    parts = [cfg.partition(c) for c in g.columns]
    return (min(parts), max(parts))


def op_intervals(op: Operation, cfg: PartitionConfig) -> List[Tuple[int, int]]:
    """Sorted section intervals of a logic op; raises if they overlap.

    Disjointness is the *physical* requirement shared by every model: two
    concurrent gates must live in electrically isolated sections.
    """
    assert not op.is_init
    ivals = sorted(gate_interval(g, cfg) for g in op.gates)
    for (l0, r0), (l1, r1) in zip(ivals, ivals[1:]):
        if r0 >= l1:
            raise LegalityError(
                f"concurrent gates overlap partitions: [{l0},{r0}] and [{l1},{r1}]"
            )
    return ivals


def tight_selects(op: Operation, cfg: PartitionConfig) -> List[bool]:
    """Tight section division (paper §3.2.2) as transistor 'selects'.

    ``selects[i]`` refers to the transistor between partitions ``i`` and
    ``i+1``; ``True`` means *selected* = non-conducting = a section boundary.
    Tight: a transistor conducts only if some gate's section spans it.
    """
    assert not op.is_init
    selects = [True] * (cfg.k - 1)
    for g in op.gates:
        l, r = gate_interval(g, cfg)
        for i in range(l, r):
            selects[i] = False
    return selects
