"""Arithmetic the metric readers share.  Each reader
(``bench/metrics/<name>.py``) is ``read(run) -> float or None``; None
means the run had nothing to read, and the metric is left out of the
line (a share of a roofline or a peak is never reported as 0)."""
from __future__ import annotations

from typing import List, Optional

from bench.harness import arith
from bench.harness.closed_loop import percentile

QUANT_KERNEL = "quant_matmul_kernel"
CROSSBAR_KERNEL = "crossbar_exec_kernel"


def generated_tokens(run) -> int:
    return sum(s.admitted + s.decode_tokens for s in run.steps)


def prompt_tokens(run) -> int:
    return sum(s.prefill_tokens for s in run.steps)


def ms_percentile(values: List[float], q: float) -> Optional[float]:
    v = percentile(values, q)
    return None if v is None else v * 1e3


def idle_share(run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(run) -> Optional[float]:
    """Model FLOPs of every token the traced steps processed (prompt and
    generated) over the traced window at the int8 peak, in %."""
    t = run.trace
    steps = run.traced_steps
    if t is None or not steps or t.busy_s <= 0:
        return None
    tokens = sum(s.prefill_tokens + s.decode_tokens for s in steps)
    flops = run.cell.reference.model_flops(run.cell.arch, tokens)
    return 100.0 * flops / (t.window_s * arith.PEAK_INT8_OPS)


def _bounds(run, phase: str, mode: str) -> float:
    linears = run.cell.reference.step_linears(run.cell.arch)
    total = 0.0
    for s in run.traced_steps:
        if phase == "decode" and s.decode_tokens:
            total += arith.linear_bound_s(linears, s.decode_tokens, mode)
        if phase == "prefill":
            total += sum(arith.linear_bound_s(linears, n, mode)
                         for n in s.prompts)
    return total


def roofline(run, kernel: str, phase: str) -> Optional[float]:
    """Sum of the least times of the linears the traced steps of
    ``phase`` ran, over the device time of ``kernel`` under that phase's
    span, in %."""
    t = run.trace
    if t is None:
        return None
    span = "bench:decode" if phase == "decode" else "bench:admit"
    dev = t.kernel_s(kernel, span)
    mode = "quant" if kernel == QUANT_KERNEL else "pim_sim"
    bound = _bounds(run, phase, mode)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev

