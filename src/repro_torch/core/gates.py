"""Stateful-logic gate definitions for digital memristive PIM.

Binary values are stored as memristor resistance states; stateful logic
(MAGIC [Kvatinsky'14], FELIX [Gupta'18]) executes a gate across *all rows*
of a crossbar in one cycle by applying voltages on bitlines.

The simulator bit-packs 32 rows into one 32-bit word, so a gate is a
bitwise function on words.  The port keeps crossbar state as ``int32``
tensors holding the same bits as the reference's ``uint32`` words (PyTorch
lacks the bitwise ops on ``uint32`` on the CPU), so ``ALL_ONES`` is the
all-ones ``int32`` word, ``-1``.  The paper's evaluation (and ours) assumes
the NOT/NOR gate set of MAGIC; the FELIX extensions (OR, NAND, AND) are
defined here as well and are legal in every partition model (the control
message carries the gate type out-of-band, see ``core/control.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

__all__ = ["GateDef", "GATE_DEFS", "GATE_CODES", "gate_by_code", "ALL_ONES"]

ALL_ONES = torch.tensor(-1, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class GateDef:
    """A stateful-logic gate executable in a single crossbar cycle."""

    name: str
    n_inputs: int
    code: int  # microcode id used by the executors (kernel + plain version)
    fn: Callable[..., torch.Tensor]

    def __call__(self, *words):
        assert len(words) == self.n_inputs, (self.name, len(words))
        return self.fn(*words)


def _init() -> torch.Tensor:
    # MAGIC initialization: output memristors are SET to logic '1'.
    return ALL_ONES


def _not(a):
    return torch.bitwise_not(a)


def _nor(a, b):
    return torch.bitwise_not(torch.bitwise_or(a, b))


def _or(a, b):
    return torch.bitwise_or(a, b)


def _nand(a, b):
    return torch.bitwise_not(torch.bitwise_and(a, b))


def _and(a, b):
    return torch.bitwise_and(a, b)


# Codes are stable ABI for the microcode executors; INIT must be 0.
GATE_DEFS: Dict[str, GateDef] = {
    "INIT": GateDef("INIT", 0, 0, _init),
    "NOT": GateDef("NOT", 1, 1, _not),
    "NOR": GateDef("NOR", 2, 2, _nor),
    "OR": GateDef("OR", 2, 3, _or),
    "NAND": GateDef("NAND", 2, 4, _nand),
    "AND": GateDef("AND", 2, 5, _and),
}

GATE_CODES: Dict[str, int] = {name: g.code for name, g in GATE_DEFS.items()}
_BY_CODE: Tuple[GateDef, ...] = tuple(
    sorted(GATE_DEFS.values(), key=lambda g: g.code)
)


def gate_by_code(code: int) -> GateDef:
    return _BY_CODE[code]
