"""Bit-plane transposition between ``pim_sim`` operands, crossbar state and
accumulators (``csrc/pim_bits.cu``)."""
from repro_torch.kernels.pim_bits.pim_bits import (
    MAX_ACC_BITS, MAX_BITS, launches, read_accumulators,
    read_accumulators_ref, write_operand, write_operand_ref)

__all__ = ["MAX_ACC_BITS", "MAX_BITS", "launches", "read_accumulators",
           "read_accumulators_ref", "write_operand", "write_operand_ref"]
