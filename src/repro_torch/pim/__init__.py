"""PIM algorithms on the PartitionPIM core: executor, arithmetic, engine,
cost model, autotuner.

``repro_torch.pim.engine`` is the execution surface: compile-once /
execute-many artifacts, persistent sessions, the backend registry, and the
``mode(...)`` selection that ``models.layers.linear`` honours.
``repro_torch.pim.autotune`` is the planner on top of it: cost-model-driven
configuration search with timed-trial tie-breaks and a persistable tuning
table.  The other modules are the synthesis (program construction) and
simulation layers underneath.
"""
from repro_torch.pim import autotune, engine, executor
from repro_torch.pim.autotune import TunedPlan
from repro_torch.pim.mult_serial import SerialMultiplier, build_serial_multiplier
from repro_torch.pim.mult_serial_fast import build_fast_serial_multiplier
from repro_torch.pim.compressor42 import build_compressor42_multiplier
from repro_torch.pim.multpim import PartitionedMultiplier, build_multpim
from repro_torch.pim.matmul import PimDot, build_dot, pim_matmul_int
from repro_torch.pim.cost_model import (GemmCost, PimDeviceParams, gemm_cost,
                                        mult_cost)

__all__ = [
    "autotune",
    "engine",
    "executor",
    "TunedPlan",
    "SerialMultiplier",
    "build_serial_multiplier",
    "build_fast_serial_multiplier",
    "build_compressor42_multiplier",
    "PartitionedMultiplier",
    "build_multpim",
    "PimDot",
    "build_dot",
    "pim_matmul_int",
    "GemmCost",
    "PimDeviceParams",
    "gemm_cost",
    "mult_cost",
]
