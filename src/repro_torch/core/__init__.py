"""PartitionPIM core: partition models, half-gate periphery, control codecs."""
from repro_torch.core.gates import GATE_CODES, GATE_DEFS, gate_by_code
from repro_torch.core.operation import (
    GateOp,
    InitOp,
    LegalityError,
    Operation,
    PartitionConfig,
    gate_interval,
    op_intervals,
    tight_selects,
)
from repro_torch.core.models import MODELS, is_legal, validate
from repro_torch.core.control import decode, encode, message_bits
from repro_torch.core.program import Program, ProgramBuilder, ProgramStats
from repro_torch.core import bounds, periphery

__all__ = [
    "GATE_CODES",
    "GATE_DEFS",
    "gate_by_code",
    "GateOp",
    "InitOp",
    "LegalityError",
    "Operation",
    "PartitionConfig",
    "gate_interval",
    "op_intervals",
    "tight_selects",
    "MODELS",
    "is_legal",
    "validate",
    "decode",
    "encode",
    "message_bits",
    "Program",
    "ProgramBuilder",
    "ProgramStats",
    "bounds",
    "periphery",
]
