"""Programs: validated sequences of crossbar operations + cost accounting.

A :class:`Program` is the unit the benchmarks measure, mirroring the paper's
evaluation metrics (§5):

* **latency**  — number of cycles = number of operations (each operation,
  init included, occupies one crossbar cycle and one control message);
* **energy**   — stateful-logic energy is dominated by memristor switching,
  approximated by the total gate count [Ronen'21]; init SETs are counted
  separately (``init_columns``) and reported both ways;
* **area**     — algorithmic area = distinct memristor columns used per row;
* **control**  — total control traffic = cycles x message_bits(model).

``Program.validate()`` checks every operation against the model's legality
rules; ``Program.check_messages()`` additionally runs every operation through
the *actual* control codec (encode -> decode -> same gates), proving the
reported message lengths really carry the program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core import control as control_mod
from repro_torch.core.gates import GATE_CODES
from repro_torch.core.models import validate as validate_op
from repro_torch.core.operation import (
    GateOp,
    InitOp,
    LegalityError,
    Operation,
    PartitionConfig,
)

__all__ = ["Program", "ProgramStats", "ProgramBuilder"]

# Microcode ABI: rows of (gate_code, in_a, in_b, out); INIT rows use
# (0, 0, 0, col).  Executors (the crossbar kernel and its plain version)
# consume this flat form.
MICROCODE_WIDTH = 4


@dataclasses.dataclass
class ProgramStats:
    cycles: int
    logic_gates: int
    init_columns: int
    area_columns: int
    control_bits_per_message: int
    total_control_bits: int
    op_class_counts: Dict[str, int]

    @property
    def energy_gates(self) -> int:
        """Paper §5.4 proxy: total gate count (logic + init switching)."""
        return self.logic_gates + self.init_columns


@dataclasses.dataclass
class Program:
    cfg: PartitionConfig
    model: str
    ops: List[Operation] = dataclasses.field(default_factory=list)
    name: str = ""

    def append(self, op: Operation) -> None:
        self.ops.append(op)

    def validate(self) -> None:
        for i, op in enumerate(self.ops):
            try:
                validate_op(op, self.cfg, self.model)
            except LegalityError as e:
                raise LegalityError(f"op {i} ({op.label or op.gate_type}): {e}") from e

    def check_messages(self, sample_every: int = 1) -> None:
        """Round-trip every (sample_every-th) op through the control codec."""
        for i, op in enumerate(self.ops):
            if i % sample_every:
                continue
            msg = control_mod.encode(op, self.cfg, self.model)
            back = control_mod.decode(msg, self.cfg, self.model, op.gate_type)
            if op.is_init:
                want = set(op.init.columns(self.cfg))
                got = set(back.init.columns(self.cfg))
            else:
                want = {(g.gate, g.inputs, g.output) for g in op.gates}
                got = {(g.gate, g.inputs, g.output) for g in back.gates}
            if want != got:
                raise LegalityError(
                    f"codec roundtrip mismatch at op {i} ({op.label}): "
                    f"{sorted(want)[:4]} != {sorted(got)[:4]}"
                )

    # -- cost accounting ----------------------------------------------------

    def stats(self) -> ProgramStats:
        logic = 0
        init_cols = 0
        used: Set[int] = set()
        classes: Dict[str, int] = {}
        for op in self.ops:
            cls = op.classify(self.cfg)
            classes[cls] = classes.get(cls, 0) + 1
            if op.is_init:
                cols = op.init.columns(self.cfg)
                init_cols += len(cols)
                used.update(cols)
            else:
                logic += len(op.gates)
                for g in op.gates:
                    used.update(g.columns)
        bits = control_mod.message_bits(self.model, self.cfg)
        return ProgramStats(
            cycles=len(self.ops),
            logic_gates=logic,
            init_columns=init_cols,
            area_columns=len(used),
            control_bits_per_message=bits,
            total_control_bits=bits * len(self.ops),
            op_class_counts=classes,
        )

    # -- microcode ------------------------------------------------------------

    def to_microcode(self) -> np.ndarray:
        """Flatten to (G, 4) int32 microcode for the executors.

        Gates within one operation are electrically concurrent in disjoint
        sections, hence order-independent; the executor applies them
        sequentially, which is semantics-preserving (validated legality
        guarantees column-disjointness inside an operation).
        """
        rows: List[Tuple[int, int, int, int]] = []
        for op in self.ops:
            if op.is_init:
                for c in op.init.columns(self.cfg):
                    rows.append((GATE_CODES["INIT"], 0, 0, c))
            else:
                for g in op.gates:
                    code = GATE_CODES[g.gate]
                    in_a = g.inputs[0]
                    in_b = g.inputs[1] if len(g.inputs) > 1 else g.inputs[0]
                    rows.append((code, in_a, in_b, g.output))
        if not rows:
            return np.zeros((0, MICROCODE_WIDTH), np.int32)
        return np.asarray(rows, np.int32)


class ProgramBuilder:
    """Convenience builder used by the arithmetic algorithms.

    This is the ONE program-construction API: ``pim/matmul.py``,
    ``pim/multpim.py`` and ``pim/mult_serial.py`` all emit operations
    through it (they used to carry private ``_B`` clones).  Three layers of
    helpers:

    * raw:        ``emit`` (append a pre-built Operation);
    * gate-level: ``gate`` (one serial gate), ``par`` (one fused parallel
      operation), ``init_range`` / ``init_periodic`` (SET windows);
    * model-aware: ``try_op`` / ``fuse_or`` append a fused operation if it
      is legal under the program's model and otherwise the provided legal
      fallback decomposition — the mechanism the paper uses to adapt
      MultPIM to standard/minimal (§5).
    """

    def __init__(self, cfg: PartitionConfig, model: str, name: str = ""):
        self.program = Program(cfg=cfg, model=model, name=name)
        self.cfg = cfg
        self.model = model

    # -- raw ----------------------------------------------------------------

    def emit(self, op: Operation) -> None:
        self.program.append(op)

    # -- gate level ---------------------------------------------------------

    def op(self, *gates: GateOp, label: str = "") -> None:
        self.program.append(Operation(gates=tuple(gates), label=label))

    def init(self, init_op: InitOp, label: str = "") -> None:
        self.program.append(Operation(init=init_op, label=label))

    def gate(self, name: str, ins: Iterable[int], out: int,
             label: str = "") -> None:
        """One serial gate as its own operation."""
        self.program.append(
            Operation(gates=(GateOp(name, tuple(ins), out),), label=label))

    def par(self, gates: Iterable[GateOp], label: str = "") -> None:
        """One parallel operation of concurrent gates."""
        self.program.append(Operation(gates=tuple(gates), label=label))

    def init_range(self, lo: int, hi: int, label: str = "") -> None:
        """SET the contiguous column range ``[lo, hi]``."""
        self.program.append(Operation(init=InitOp("range", lo, hi),
                                      label=label))

    def init_periodic(self, ilo: int, ihi: int, p_start: int = 0,
                      p_end: Optional[int] = None, period: int = 1,
                      label: str = "") -> None:
        """SET intra range ``[ilo, ihi]`` in partitions ``p_start..p_end``
        (default: all) with the given period."""
        p_end = self.cfg.k - 1 if p_end is None else p_end
        self.program.append(Operation(
            init=InitOp("periodic", ilo, ihi, p_start, p_end, period),
            label=label))

    # -- model-aware --------------------------------------------------------

    def fuse_or(self, fused: Operation, fallback: Iterable[Operation],
                label: str = "") -> bool:
        """Append ``fused`` if legal under the model, else ``fallback``."""
        return self.try_op((fused,), fallback, label=label)

    def try_op(
        self,
        fused: Iterable[Operation],
        fallback: Iterable[Operation],
        label: str = "",
    ) -> bool:
        """Append ``fused`` if every op in it is legal; else ``fallback``."""
        from repro_torch.core.models import is_legal

        fused = list(fused)
        if all(is_legal(o, self.cfg, self.model) for o in fused):
            for o in fused:
                self.program.append(o)
            return True
        for o in fallback:
            self.program.append(o)
        return False

    def build(self, check: bool = True) -> Program:
        if check:
            self.program.validate()
        return self.program
