"""The benchmark's frozen arithmetic of the modes: published peaks and each
kernel's least time.

Copied, not imported, from the program (``chip_smoke.py``'s
``crossbar_bound_ms`` and the 37-term dot program's gate count), so that a
change to the program cannot move the yardstick.  A model's own arithmetic
(its FLOPs, the linears a step runs) is its reference's
(``Cell.reference``); the default reference's names stay importable from
here.  Every function here is host arithmetic on sizes."""
from __future__ import annotations

import math
from typing import List, Tuple

from bench.reference.model_arith import (  # noqa: F401
    active_params, model_flops, param_count, recurrence_flops, step_linears)

# H100 SXM published peaks (NVIDIA data sheet; dense; at 700 W)
PEAK_INT8_OPS = 1979e12           # int8 tensor-core operations per second
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer logic on the INT32 lanes: 64 per SM per clock x 132 SMs x
# 1.98 GHz (NVIDIA H100 Tensor Core GPU Architecture white paper)
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# The crossbar simulator's layout of one 8-bit (7-bit offset) dot product:
# 37 terms per chunk, 256 rows per crossbar, 1024 columns of 8 32-bit
# words, and the 37-term program's 86,320 gates of 4 int32 fields each.
PIM_TERMS = 37
PIM_ROWS = 256
PIM_COLS = 1024
PIM_WORDS = PIM_ROWS // 32
PIM_GATES = 86_320
PIM_GATE_FIELDS = 4


def quant_bound_s(m: int, k: int, n: int) -> float:
    """Least time of one int8 GEMM (M, K) x (K, N): its operations at the
    int8 peak, or int8 operands read once and the int32 result written
    once over HBM, whichever is longer."""
    return max(2.0 * m * k * n / PEAK_INT8_OPS,
               (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S)


def quant_bound_by(m: int, k: int, n: int) -> str:
    ops = 2.0 * m * k * n / PEAK_INT8_OPS
    return "operations" if ops >= quant_bound_s(m, k, n) else "bytes"


def pim_crossbars(m: int, k: int, o: int) -> int:
    """Crossbars one pim_sim linear at (M, K, O) runs on."""
    return math.ceil(k / PIM_TERMS) * math.ceil(m * o / PIM_ROWS)


def crossbar_bound_s(m: int, k: int, o: int) -> float:
    """Least time of one pim_sim linear on the crossbar kernel: the state
    read and written once and the program read once over HBM, or one
    32-bit logic operation per gate per row-word, whichever is longer."""
    c = pim_crossbars(m, k, o)
    t_bytes = (2 * c * PIM_COLS * PIM_WORDS * 4
               + PIM_GATES * PIM_GATE_FIELDS * 4) / HBM_BYTES_PER_S
    t_ops = PIM_GATES * c * PIM_WORDS / INT32_OPS_PER_S
    return max(t_bytes, t_ops)


def crossbar_bound_by(m: int, k: int, o: int) -> str:
    c = pim_crossbars(m, k, o)
    t_ops = PIM_GATES * c * PIM_WORDS / INT32_OPS_PER_S
    return "operations" if t_ops >= crossbar_bound_s(m, k, o) else "bytes"


def linear_bound_s(linears: List[Tuple[int, int]], rows: int, mode: str
                   ) -> float:
    """Least seconds of a step's ``linears`` ((K, N) each, a reference's
    ``step_linears``) over ``rows`` token rows in ``mode``'s kernel."""
    fn = quant_bound_s if mode == "quant" else crossbar_bound_s
    return sum(fn(rows, k, n) for k, n in linears)
