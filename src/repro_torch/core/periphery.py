"""Crossbar periphery: the half-gates technique (paper §2.2, Table 1, Fig 4/5).

Each partition has its own small column decoder (k CMOS n/k-decoders replace
one CMOS n-decoder — *fewer* CMOS gates than a partition-free crossbar) plus a
3-bit opcode ``(enA, enB, enOut)``:

    ===== ==========================  ===== ==========================
    000   —                            100   Gate(InA,?) -> ?
    001   ? -> Out                     101   Gate(InA,?) -> Out
    010   Gate(?,InB) -> ?             110   Gate(InA,InB) -> ?
    011   Gate(?,InB) -> Out           111   Gate(InA,InB) -> Out
    ===== ==========================  ===== ==========================

A partition applies only the halves its opcode enables; the *combination* of
half-gates along a section forms one valid gate.  This module implements:

* :func:`op_opcodes` — the opcodes/indices a controller derives for a given
  operation (the unlimited model's message payload).
* :func:`standard_opcode_generator` — §3.2.2: opcodes from transistor selects
  + per-partition enables + a global direction bit (two 2:1 muxes/partition).
* :func:`minimal_range_generator` — §4.2: input opcodes from a range
  generator (p_start, p_end, period), output opcodes by shifting by the
  partition distance, transistor selects derived from the opcodes.
* :func:`simulate_voltages` / :func:`sections_from_selects` — an electrical-
  level check that the applied half-gates combine into exactly the intended
  gates (used by the tests as an independent validation path).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.gates import GATE_DEFS
from repro_torch.core.operation import (
    GateOp,
    LegalityError,
    Operation,
    PartitionConfig,
    tight_selects,
)

__all__ = [
    "PartitionOpcode",
    "op_opcodes",
    "standard_opcode_generator",
    "minimal_range_generator",
    "sections_from_selects",
    "simulate_voltages",
]


@dataclasses.dataclass(frozen=True)
class PartitionOpcode:
    """Opcode + intra-partition indices for one partition's column decoder."""

    en_a: bool = False
    en_b: bool = False
    en_out: bool = False
    idx_a: int = 0
    idx_b: int = 0
    idx_out: int = 0

    @property
    def bits(self) -> int:
        return (self.en_a << 2) | (self.en_b << 1) | int(self.en_out)


def op_opcodes(
    op: Operation, cfg: PartitionConfig
) -> Tuple[List[PartitionOpcode], List[bool]]:
    """Derive per-partition opcodes + tight transistor selects for a logic op.

    This is exactly what the unlimited model's control message carries.
    Half-gates: the input partition of a gate raises ``en_a``/``en_b``; the
    output partition raises ``en_out``; intermediate partitions stay at 000.
    Split-input gates (unlimited only) raise ``en_a`` and ``en_b`` in
    different partitions.
    """
    assert not op.is_init
    ops: List[Dict] = [dict(en_a=False, en_b=False, en_out=False,
                            idx_a=0, idx_b=0, idx_out=0) for _ in range(cfg.k)]
    for g in op.gates:
        pa = cfg.partition(g.inputs[0])
        ops[pa]["en_a"] = True
        ops[pa]["idx_a"] = cfg.intra(g.inputs[0])
        if len(g.inputs) > 1:
            pb = cfg.partition(g.inputs[1])
            ops[pb]["en_b"] = True
            ops[pb]["idx_b"] = cfg.intra(g.inputs[1])
        po = cfg.partition(g.output)
        ops[po]["en_out"] = True
        ops[po]["idx_out"] = cfg.intra(g.output)
    return [PartitionOpcode(**o) for o in ops], tight_selects(op, cfg)


def standard_opcode_generator(
    selects: Sequence[bool], enables: Sequence[bool], direction: int
) -> List[Tuple[bool, bool, bool]]:
    """§3.2.2 opcode generation — two 2:1 multiplexers per partition.

    ``selects[i]`` is the transistor between partitions i and i+1 (True =
    selected = non-conducting = section boundary); the crossbar edges are
    implicit boundaries.  For direction +1 ("inputs left of outputs") the
    input-enable of partition p is the select of the transistor to its LEFT
    (p is then the leftmost partition of its section, where the standard
    model's gates keep their inputs) and the output-enable is the select to
    its RIGHT; vice versa for direction -1.  Everything is ANDed with the
    partition enable.
    """
    k = len(enables)
    assert len(selects) == k - 1
    out: List[Tuple[bool, bool, bool]] = []
    for p in range(k):
        left = selects[p - 1] if p > 0 else True
        right = selects[p] if p < k - 1 else True
        in_en = left if direction >= 0 else right
        out_en = right if direction >= 0 else left
        e = bool(enables[p])
        out.append((in_en and e, in_en and e, out_en and e))
    return out


def minimal_range_generator(
    k: int, p_start: int, p_end: int, period: int, distance: int, direction: int
) -> Tuple[List[bool], List[bool], List[bool]]:
    """§4.2 periphery: (input enables, output enables, transistor selects).

    * input enables: logical one every ``period`` partitions in
      ``[p_start, p_end]`` (two shifters + a decoder in hardware);
    * output enables: input enables shifted by ``distance`` along
      ``direction`` (up-to-k shifter);
    * transistor selects: derived — for direction +1, the transistor between
      p and p+1 isolates iff an *output* sits at p (a gate ends there) or an
      *input* sits at p+1 (a gate begins there); mirrored for direction -1.
    """
    in_en = [False] * k
    for p in range(p_start, p_end + 1, max(period, 1)):
        in_en[p] = True
    out_en = [False] * k
    for p in range(k):
        if in_en[p]:
            q = p + distance * (1 if direction >= 0 else -1)
            if not 0 <= q < k:
                raise LegalityError(f"output partition {q} out of range")
            out_en[q] = True
    selects = []
    for i in range(k - 1):
        if direction >= 0:
            selects.append(out_en[i] or in_en[i + 1])
        else:
            selects.append(in_en[i] or out_en[i + 1])
    return in_en, out_en, selects


def sections_from_selects(selects: Sequence[bool]) -> List[Tuple[int, int]]:
    """Partition intervals induced by transistor selects (True = boundary)."""
    k = len(selects) + 1
    sections = []
    start = 0
    for i in range(k - 1):
        if selects[i]:
            sections.append((start, i))
            start = i + 1
    sections.append((start, k - 1))
    return sections


def simulate_voltages(
    opcodes: Sequence[PartitionOpcode],
    selects: Sequence[bool],
    cfg: PartitionConfig,
    gate_type: str,
) -> List[GateOp]:
    """Electrically combine half-gates into whole gates.

    Applies each partition's half-gate voltages onto its bitlines, splits the
    crossbar by the (non-)conducting transistors, and checks each section
    carries either nothing or exactly one valid gate's voltages (the right
    number of input drivers and exactly one output driver).  Returns the
    reconstructed gates — the tests assert these equal the intended ones.
    """
    n_inputs = GATE_DEFS[gate_type].n_inputs
    gates: List[GateOp] = []
    for lo, hi in sections_from_selects(selects):
        a_cols: List[int] = []
        b_cols: List[int] = []
        out_cols: List[int] = []
        for p in range(lo, hi + 1):
            oc = opcodes[p]
            if oc.en_a:
                a_cols.append(cfg.col(p, oc.idx_a))
            if oc.en_b:
                b_cols.append(cfg.col(p, oc.idx_b))
            if oc.en_out:
                out_cols.append(cfg.col(p, oc.idx_out))
        if not (a_cols or b_cols or out_cols):
            continue  # idle section
        if len(out_cols) != 1:
            raise LegalityError(f"section [{lo},{hi}]: {len(out_cols)} output drivers")
        if n_inputs >= 1 and len(a_cols) != 1:
            raise LegalityError(f"section [{lo},{hi}]: {len(a_cols)} InA drivers")
        if n_inputs == 2 and len(b_cols) != 1:
            raise LegalityError(f"section [{lo},{hi}]: {len(b_cols)} InB drivers")
        inputs = tuple(a_cols[:1] + b_cols[:1])[:n_inputs]
        gates.append(GateOp(gate_type, inputs, out_cols[0]))
    return gates
