"""The three partition models (paper §2–§4) as legality checkers.

* ``baseline``  — crossbar without partitions: one gate per cycle.
* ``unlimited`` — any set of gates in disjoint sections (§2); per-partition
                  opcodes + indices; 607-bit messages at (k=32, n=1024).
* ``standard``  — §3 restrictions: *Identical Indices*, *No Split-Input*,
                  *Uniform Direction*; 79-bit messages.
* ``minimal``   — §4 restrictions (in addition): *Uniform Partition-Distance*
                  and *Periodic*; 36-bit messages.

``validate(op, cfg, model)`` raises :class:`LegalityError` with the violated
criterion; algorithms use ``is_legal`` to pick between a fused operation and
its legal decomposition, which is exactly how the paper's evaluation replaces
MultPIM's unsupported operations with compatible alternatives (§5, fn. 4/5).
"""
from __future__ import annotations


from repro_torch.core.operation import (GateOp, InitOp, LegalityError, Operation,
                                  PartitionConfig, op_intervals)

__all__ = ["MODELS", "validate", "is_legal", "gate_direction", "gate_distance"]

MODELS = ("baseline", "unlimited", "standard", "minimal")


def gate_direction(g: GateOp, cfg: PartitionConfig) -> int:
    """+1 if inputs left of output, -1 if right, 0 if same partition."""
    in_part = cfg.partition(g.inputs[0])
    out_part = cfg.partition(g.output)
    return (out_part > in_part) - (out_part < in_part)


def gate_distance(g: GateOp, cfg: PartitionConfig) -> int:
    """Partition distance (paper §4.1): |output partition - input partition|."""
    return abs(cfg.partition(g.output) - cfg.partition(g.inputs[0]))


def _check_no_split_input(op: Operation, cfg: PartitionConfig) -> None:
    for g in op.gates:
        parts = {cfg.partition(c) for c in g.inputs}
        if len(parts) > 1:
            raise LegalityError(f"split input across partitions {parts} ({g})")


def _check_identical_indices(op: Operation, cfg: PartitionConfig) -> None:
    in_a = {cfg.intra(g.inputs[0]) for g in op.gates}
    in_b = {cfg.intra(g.inputs[1]) for g in op.gates if len(g.inputs) > 1}
    out = {cfg.intra(g.output) for g in op.gates}
    for name, s in (("InA", in_a), ("InB", in_b), ("Out", out)):
        if len(s) > 1:
            raise LegalityError(f"intra-partition {name} indices differ: {sorted(s)}")


def _check_uniform_direction(op: Operation, cfg: PartitionConfig) -> None:
    dirs = {gate_direction(g, cfg) for g in op.gates} - {0}
    if len(dirs) > 1:
        raise LegalityError("both gate directions present in one operation")


def _check_minimal(op: Operation, cfg: PartitionConfig) -> None:
    dists = {gate_distance(g, cfg) for g in op.gates}
    if len(dists) > 1:
        raise LegalityError(f"non-uniform partition distance: {sorted(dists)}")
    d = dists.pop()
    ips = sorted(cfg.partition(g.inputs[0]) for g in op.gates)
    if len(ips) != len(set(ips)):
        raise LegalityError("two concurrent gates share an input partition")
    if len(ips) >= 2:
        diffs = {b - a for a, b in zip(ips, ips[1:])}
        if len(diffs) > 1:
            raise LegalityError(f"input partitions not periodic: {ips}")
        t = diffs.pop()
        if t <= d:
            raise LegalityError(f"period T={t} must exceed partition distance {d}")
        if t > cfg.k - 1:
            raise LegalityError(f"period T={t} not encodable with log2(k) bits")


def _check_init(init: InitOp, cfg: PartitionConfig, model: str) -> None:
    if init.kind == "range":
        if not (0 <= init.lo <= init.hi < cfg.n):
            raise LegalityError(f"init range [{init.lo},{init.hi}] out of bounds")
        return
    if init.kind == "periodic":
        if model == "baseline":
            raise LegalityError("periodic init needs partitions")
        if not (0 <= init.lo <= init.hi < cfg.m):
            raise LegalityError("periodic init intra range out of bounds")
        if not (0 <= init.p_start <= init.p_end < cfg.k):
            raise LegalityError("periodic init partition range out of bounds")
        if init.period < 1 or init.period > max(1, cfg.k - 1):
            raise LegalityError(f"bad init period {init.period}")
        return
    raise LegalityError(f"unknown init kind {init.kind!r}")


def validate(op: Operation, cfg: PartitionConfig, model: str) -> None:
    """Raise LegalityError iff ``op`` is illegal under ``model``."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}")
    if op.is_init:
        _check_init(op.init, cfg, model)
        return
    for g in op.gates:
        for c in g.columns:
            if not 0 <= c < cfg.n:
                raise LegalityError(f"column {c} out of range")
    if model == "baseline":
        if len(op.gates) != 1:
            raise LegalityError("baseline crossbar: one gate per cycle")
        return
    # Physical requirement for all partition models: disjoint sections.
    op_intervals(op, cfg)
    if model == "unlimited":
        return
    _check_no_split_input(op, cfg)
    _check_identical_indices(op, cfg)
    _check_uniform_direction(op, cfg)
    if model == "minimal":
        _check_minimal(op, cfg)


def is_legal(op: Operation, cfg: PartitionConfig, model: str) -> bool:
    try:
        validate(op, cfg, model)
        return True
    except LegalityError:
        return False
