"""Controller→crossbar control messages (paper §2.3, §3.3, §4.3).

Implements the *actual bit-level codecs* for the four designs, so the paper's
message lengths are measured from working encoders rather than asserted:

    ============  ==============================================  =======
    design        bit formula                                      k=32,
                                                                   n=1024
    ============  ==============================================  =======
    baseline      3*log2(n)                                        30
    unlimited     3k*log2(n/k) + 3k + (k-1)                        607
    standard      3*log2(n/k) + (2k-1) + 1                         79
    minimal       3*log2(n/k) + 3*log2(k) + log2(k) + 1            36
    ============  ==============================================  =======

Encoders take a legal :class:`Operation` and emit a bit string of *exactly*
the design's length; decoders reconstruct the operation (via the periphery
logic of ``core/periphery.py``), and the tests assert the roundtrip.  The
gate type (NOT vs NOR vs the FELIX gates) selects the analog voltage
configuration and is conveyed out-of-band, as in the paper's bit counts.

Init operations are writes; they reuse the same message framing (their index
payload fits within the design's message length), so every cycle costs one
message of the design's fixed length.
"""
from __future__ import annotations

import math
from typing import List

from repro_torch.core.models import gate_direction, gate_distance, validate
from repro_torch.core.operation import (
    GateOp,
    LegalityError,
    Operation,
    PartitionConfig,
    tight_selects,
)
from repro_torch.core.periphery import (PartitionOpcode, minimal_range_generator,
                                  op_opcodes, simulate_voltages,
                                  standard_opcode_generator)

__all__ = [
    "message_bits",
    "encode",
    "decode",
    "BitWriter",
    "BitReader",
]


def _log2(x: int) -> int:
    l = int(math.log2(x))
    assert (1 << l) == x, f"{x} must be a power of two"
    return l


def message_bits(model: str, cfg: PartitionConfig) -> int:
    """Message length in bits for one cycle under each design."""
    n, k, m = cfg.n, cfg.k, cfg.m
    if model == "baseline":
        return 3 * _log2(n)
    if model == "unlimited":
        return 3 * k * _log2(m) + 3 * k + (k - 1)
    if model == "standard":
        return 3 * _log2(m) + (2 * k - 1) + 1
    if model == "minimal":
        return 3 * _log2(m) + 3 * _log2(k) + _log2(k) + 1
    raise ValueError(model)


class BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def write(self, value: int, width: int) -> "BitWriter":
        assert 0 <= value < (1 << width), (value, width)
        for i in reversed(range(width)):
            self.bits.append((value >> i) & 1)
        return self

    def write_flag(self, b: bool) -> "BitWriter":
        self.bits.append(int(b))
        return self

    def payload(self, total: int) -> str:
        assert len(self.bits) <= total, (len(self.bits), total)
        return "".join(map(str, self.bits)) + "0" * (total - len(self.bits))


class BitReader:
    def __init__(self, s: str):
        self.s = s
        self.pos = 0

    def read(self, width: int) -> int:
        v = int(self.s[self.pos : self.pos + width], 2)
        self.pos += width
        return v

    def read_flag(self) -> bool:
        return bool(self.read(1))


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------
# Every message starts with a 2-bit frame [is_init, init_kind] carried on the
# command lines alongside the (out-of-band) gate-type selection; the paper's
# message-length accounting covers the index/opcode payload, which is what the
# ``message_bits`` formulas (and our payload widths) measure.


def _encode_init(op: Operation, cfg: PartitionConfig, model: str, w: BitWriter):
    init = op.init
    lg_n, lg_m, lg_k = _log2(cfg.n), _log2(cfg.m), _log2(cfg.k)
    if init.kind == "range":
        width = lg_n if model in ("baseline", "unlimited") else lg_m
        if model in ("baseline", "unlimited"):
            w.write(init.lo, width).write(init.hi, width)
        else:
            # standard/minimal: absolute range re-expressed as (partition,
            # intra) pairs; must live inside one partition or span aligned.
            p_lo, p_hi = cfg.partition(init.lo), cfg.partition(init.hi)
            if p_lo == p_hi:
                w.write_flag(False)
                w.write(cfg.intra(init.lo), lg_m).write(cfg.intra(init.hi), lg_m)
                w.write(p_lo, lg_k)
            else:  # spanning range init (e.g. clearing a workspace)
                if model == "minimal" and p_hi != cfg.k - 1:
                    raise LegalityError(
                        "minimal: spanning range init must end at the last partition"
                    )
                w.write_flag(True)
                w.write(cfg.intra(init.lo), lg_m).write(cfg.intra(init.hi), lg_m)
                w.write(p_lo, lg_k)
                if model == "standard":
                    w.write(p_hi, lg_k)
    else:  # periodic
        w.write(init.lo, lg_m).write(init.hi, lg_m)
        w.write(init.p_start, lg_k).write(init.p_end, lg_k)
        w.write(init.period - 1, lg_k)


def encode(op: Operation, cfg: PartitionConfig, model: str) -> str:
    """Encode a legal operation into the design's fixed-length message."""
    validate(op, cfg, model)
    total = message_bits(model, cfg)
    lg_n, lg_m, lg_k = _log2(cfg.n), _log2(cfg.m), _log2(cfg.k)
    w = BitWriter()
    w.write_flag(op.is_init)
    if op.is_init:
        w.write_flag(op.init.kind == "periodic")
        _encode_init(op, cfg, model, w)
        payload = "".join(map(str, w.bits))
        if len(payload) > total + 2:
            raise LegalityError(f"init payload {len(payload)} > frame {total + 2}")
        return payload + "0" * (total + 2 - len(payload))
    w.write_flag(False)

    if model == "baseline":
        (g,) = op.gates
        in_a = g.inputs[0]
        in_b = g.inputs[1] if len(g.inputs) > 1 else g.inputs[0]
        w.write(in_a, lg_n).write(in_b, lg_n).write(g.output, lg_n)
        return w.payload(total + 2)

    if model == "unlimited":
        opcodes, selects = op_opcodes(op, cfg)
        for oc in opcodes:
            w.write_flag(oc.en_a).write_flag(oc.en_b).write_flag(oc.en_out)
            w.write(oc.idx_a, lg_m).write(oc.idx_b, lg_m).write(oc.idx_out, lg_m)
        for s in selects:
            w.write_flag(s)
        return w.payload(total + 2)

    # standard / minimal: shared intra indices.
    g0 = op.gates[0]
    idx_a = cfg.intra(g0.inputs[0])
    idx_b = cfg.intra(g0.inputs[1]) if len(g0.inputs) > 1 else idx_a
    idx_out = cfg.intra(g0.output)
    dirs = {gate_direction(g, cfg) for g in op.gates} - {0}
    direction = dirs.pop() if dirs else 1
    w.write(idx_a, lg_m).write(idx_b, lg_m).write(idx_out, lg_m)

    if model == "standard":
        selects = tight_selects(op, cfg)
        active = [False] * cfg.k
        for g in op.gates:
            lo, hi = (
                min(cfg.partition(g.inputs[0]), cfg.partition(g.output)),
                max(cfg.partition(g.inputs[0]), cfg.partition(g.output)),
            )
            for p in range(lo, hi + 1):
                active[p] = True
        for e in active:
            w.write_flag(e)
        for s in selects:
            w.write_flag(s)
        w.write_flag(direction > 0)
        return w.payload(total + 2)

    # minimal
    dist = gate_distance(op.gates[0], cfg)
    ips = sorted(cfg.partition(g.inputs[0]) for g in op.gates)
    period = (ips[1] - ips[0]) if len(ips) >= 2 else dist + 1
    w.write(ips[0], lg_k).write(ips[-1], lg_k).write(period - 1, lg_k)
    w.write(dist, lg_k)
    w.write_flag(direction > 0)
    return w.payload(total + 2)


# ---------------------------------------------------------------------------
# Decoding — reconstructs the operation through the periphery logic.
# ---------------------------------------------------------------------------


def _decode_init(r: BitReader, cfg: PartitionConfig, model: str) -> Operation:
    from repro_torch.core.operation import InitOp

    lg_n, lg_m, lg_k = _log2(cfg.n), _log2(cfg.m), _log2(cfg.k)
    periodic = r.read_flag()
    if periodic:
        lo, hi = r.read(lg_m), r.read(lg_m)
        p_start, p_end = r.read(lg_k), r.read(lg_k)
        period = r.read(lg_k) + 1
        return Operation(init=InitOp("periodic", lo, hi, p_start, p_end, period))
    if model in ("baseline", "unlimited"):
        lo, hi = r.read(lg_n), r.read(lg_n)
        return Operation(init=InitOp("range", lo, hi))
    spanning = r.read_flag()
    ilo, ihi = r.read(lg_m), r.read(lg_m)
    p_lo = r.read(lg_k)
    if not spanning:
        return Operation(init=InitOp("range", cfg.col(p_lo, ilo), cfg.col(p_lo, ihi)))
    p_hi = r.read(lg_k) if model == "standard" else cfg.k - 1
    return Operation(init=InitOp("range", cfg.col(p_lo, ilo), cfg.col(p_hi, ihi)))


def decode(message: str, cfg: PartitionConfig, model: str, gate_type: str) -> Operation:
    """Decode a message back into an Operation (periphery-level path)."""
    from repro_torch.core.gates import GATE_DEFS

    r = BitReader(message)
    if r.read_flag():
        return _decode_init(r, cfg, model)
    r.read_flag()
    lg_n, lg_m, lg_k = _log2(cfg.n), _log2(cfg.m), _log2(cfg.k)
    n_inputs = GATE_DEFS[gate_type].n_inputs

    if model == "baseline":
        in_a, in_b, out = r.read(lg_n), r.read(lg_n), r.read(lg_n)
        inputs = (in_a, in_b)[:n_inputs]
        return Operation(gates=(GateOp(gate_type, inputs, out),))

    if model == "unlimited":
        opcodes = []
        for _ in range(cfg.k):
            en_a, en_b, en_out = r.read_flag(), r.read_flag(), r.read_flag()
            idx_a, idx_b, idx_out = r.read(lg_m), r.read(lg_m), r.read(lg_m)
            opcodes.append(
                PartitionOpcode(en_a, en_b and n_inputs == 2, en_out,
                                idx_a, idx_b, idx_out)
            )
        selects = [r.read_flag() for _ in range(cfg.k - 1)]
        gates = simulate_voltages(opcodes, selects, cfg, gate_type)
        return Operation(gates=tuple(gates))

    idx_a, idx_b, idx_out = r.read(lg_m), r.read(lg_m), r.read(lg_m)

    if model == "standard":
        enables = [r.read_flag() for _ in range(cfg.k)]
        selects = [r.read_flag() for _ in range(cfg.k - 1)]
        direction = 1 if r.read_flag() else -1
        trios = standard_opcode_generator(selects, enables, direction)
        opcodes = [
            PartitionOpcode(a, b and n_inputs == 2, o, idx_a, idx_b, idx_out)
            for (a, b, o) in trios
        ]
        gates = simulate_voltages(opcodes, selects, cfg, gate_type)
        return Operation(gates=tuple(gates))

    # minimal
    p_start, p_end = r.read(lg_k), r.read(lg_k)
    period = r.read(lg_k) + 1
    dist = r.read(lg_k)
    direction = 1 if r.read_flag() else -1
    in_en, out_en, selects = minimal_range_generator(
        cfg.k, p_start, p_end, period, dist, direction
    )
    opcodes = [
        PartitionOpcode(
            in_en[p], in_en[p] and n_inputs == 2, out_en[p], idx_a, idx_b, idx_out
        )
        for p in range(cfg.k)
    ]
    gates = simulate_voltages(opcodes, selects, cfg, gate_type)
    return Operation(gates=tuple(gates))
