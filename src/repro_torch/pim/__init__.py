"""PIM algorithms on the PartitionPIM core: executor, arithmetic, engine.

``repro_torch.pim.engine`` is the execution surface: compile-once /
execute-many artifacts, persistent sessions, and the ``mode(...)``
selection that ``models.layers.linear`` honours.  The other modules are
the synthesis (program construction) and simulation layers underneath.
"""
from repro_torch.pim import engine, executor
from repro_torch.pim.multpim import PartitionedMultiplier, build_multpim
from repro_torch.pim.matmul import PimDot, build_dot

__all__ = [
    "engine",
    "executor",
    "PartitionedMultiplier",
    "build_multpim",
    "PimDot",
    "build_dot",
]
