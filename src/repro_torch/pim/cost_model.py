"""Analytical PIM cost model for LM workloads (Bitlet-style [18]).

Scales the *measured* per-row program costs (cycles, gates, control bits —
from the cycle-accurate simulator) to full LM-layer GEMMs, using the same
mapping as ``pim/matmul.py``: one output element per crossbar row, K
multiply-accumulate steps per row, all rows/crossbars in parallel.

For any ``Linear`` of a served model, the model reports what executing it
on a PartitionPIM memristive accelerator would cost under each partition
design, including the controller->crossbar traffic that the paper's
control designs reduce by 607/79/36 bits per cycle.

``pim.autotune`` uses this model as its planner: :func:`gemm_cost` accepts
a crossbar geometry (``n_cols``) and a chunking (``chunk``) so candidate
configurations — partition model x geometry x inner-dimension split — are
priced consistently, and :func:`mult_cost` prices any ``kind="mult"``
algorithm in the engine registry (the NOR serial baseline plus the
``serial_fast`` / ``compressor42`` backends), so new multiplier algorithms
join the race by registering, not by editing this file.

Device assumptions (documented, configurable):
* crossbar: 1024 x 1024, k=32 partitions (paper's evaluation point);
* cycle time 10 ns (memristor SET/RESET limited);
* switching energy 0.1 pJ/gate  (order-of-magnitude RRAM figure);
* GPU comparison point (``GemmCost.gpu_time_s``): one NVIDIA H100 SXM at
  its 700 W power limit, 989.4 TFLOP/s dense bf16 and 3.35 TB/s HBM3
  (NVIDIA's published data-sheet peaks, not measured here).

Every integer field and every cycle, energy and control-bit count equals
the JAX reference's; only the comparison point differs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional


__all__ = ["PimDeviceParams", "GemmCost", "gemm_cost", "mult_cost"]

# NVIDIA H100 SXM (80 GB HBM3, 700 W power limit), data-sheet peaks
GPU_PEAK_FLOPS = 989.4e12
GPU_HBM_BW = 3.35e12


@dataclasses.dataclass(frozen=True)
class PimDeviceParams:
    n_cols: int = 1024
    n_rows: int = 1024
    k: int = 32
    cycle_ns: float = 10.0
    gate_energy_pj: float = 0.1
    crossbars: int = 65536  # one "PIM chip" = 64Gb of memristors


def _mult_backend(model: str) -> Optional[str]:
    """Registry name if ``model`` is a serial multiplier algorithm."""
    from repro_torch.pim import engine

    name = "serial" if model == "baseline" else model
    try:
        kind = engine.backend_kind(name)
    except ValueError:
        return None
    return name if kind == "mult" else None


@functools.lru_cache(maxsize=None)
def mult_cost(n_bits: int, model: str, n_cols: int = 1024) -> Dict[str, int]:
    """Measured per-row multiplication cost from the built programs.

    ``model`` is a partition design (``unlimited``/``standard``/``minimal``)
    or a serial multiplier algorithm from the engine's ``kind="mult"``
    registry (``baseline`` aliases ``serial``).
    """
    mult = _mult_backend(model)
    if mult is not None:
        from repro_torch.pim import engine

        prog = engine.build_multiplier(mult, n_bits, n_cols=n_cols).program
    else:
        from repro_torch.pim.multpim import build_multpim

        prog = build_multpim(n_bits, n_cols, model=model).program
    st = prog.stats()
    return dict(cycles=st.cycles, gates=st.energy_gates,
                area=st.area_columns,
                msg_bits=st.control_bits_per_message)


@functools.lru_cache(maxsize=None)
def _dot_extra_cost(n_bits: int, model: str, n_cols: int = 1024
                    ) -> Dict[str, int]:
    """Per-term cost (copies + multiply + accumulate) of the dot mapping,
    plus the per-program fixed cost (setup + final carry resolution).

    Partition models: measured from ``build_dot`` (carry-save accumulate) —
    per-term is the 1->2-term cycle delta, fixed is what a 1-term program
    costs beyond one term.  Serial algorithms: the multiplier program plus
    a serial ripple accumulate and per-bit operand copies (a crossbar
    without partitions executes one gate per cycle; there is nothing to
    fuse); the ripple constant matches the algorithm's adder family
    (9-gate NOR vs 7-gate NAND/OR/AND)."""
    if _mult_backend(model) is not None:
        mc = mult_cost(n_bits, model, n_cols)
        n = n_bits
        per_pos = 10 if model in ("serial_fast", "compressor42") else 13
        ripple = (2 * n + 2) * per_pos  # FA chain incl. per-position inits
        copies = 4 * n + 2              # double-NOT per input bit + inits
        return dict(cycles=mc["cycles"] + ripple + copies,
                    gates=mc["gates"] + (2 * n + 2) * 10 + 4 * n,
                    fixed_cycles=0)
    from repro_torch.pim.matmul import build_dot

    def build(n):
        try:
            return build_dot(n, n_bits, n_cols=n_cols, model=model)
        except ValueError:  # wide operands need a wider crossbar (m = n/k)
            return build_dot(n, n_bits, n_cols=max(n_cols, 4096), model=model)

    one = build(1).program.stats()
    two = build(2).program.stats()
    per = two.cycles - one.cycles
    return dict(cycles=per,
                gates=two.energy_gates - one.energy_gates,
                fixed_cycles=max(0, one.cycles - per))


@dataclasses.dataclass
class GemmCost:
    model: str
    n_bits: int
    m: int
    k_dim: int
    n: int
    crossbars: int          # concurrently busy crossbars
    waves: int              # sequential waves if the chip is smaller
    cycles_per_wave: int
    time_s: float
    energy_j: float
    control_bits: int       # controller->crossbar traffic for the whole GEMM
    gpu_time_s: float       # bf16 roofline time on one H100 (see above)
    n_cols: int = 1024      # crossbar geometry priced
    chunks: int = 1         # inner-dimension splits (host-summed partials)

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.k_dim * self.n


def gemm_cost(m: int, k_dim: int, n: int, n_bits: int = 8,
              model: str = "minimal",
              dev: PimDeviceParams = PimDeviceParams(),
              n_cols: Optional[int] = None,
              chunk: Optional[int] = None) -> GemmCost:
    """Cost of ``(m x k_dim) @ (k_dim x n)`` on a PartitionPIM accelerator.

    ``n_cols`` overrides the device's crossbar width (a wider row fits more
    dot terms but pays more control bits per message); ``chunk`` prices the
    engine's inner-dimension split — each of the ``ceil(k_dim / chunk)``
    chunked programs pays the fixed setup + final carry-resolution cost.
    Left as ``None``, both collapse to the classic single-program pricing
    at the device geometry.
    """
    geom = dev.n_cols if n_cols is None else n_cols
    per_term = _dot_extra_cost(n_bits, model, geom)
    rows_needed = m * n
    rows_per_cb = dev.n_rows
    cbs_needed = -(-rows_needed // rows_per_cb)
    waves = -(-cbs_needed // dev.crossbars)
    busy = min(cbs_needed, dev.crossbars)
    cycles = k_dim * per_term["cycles"]
    n_chunks = 1
    if chunk is not None and 0 < chunk < k_dim:
        n_chunks = -(-k_dim // chunk)
    if chunk is not None:
        cycles += n_chunks * per_term["fixed_cycles"]
    time_s = waves * cycles * dev.cycle_ns * 1e-9
    # energy: gates per row x rows actually computing
    gates = k_dim * per_term["gates"] * rows_needed
    energy_j = gates * dev.gate_energy_pj * 1e-12
    # control: one message per cycle per (independently-programmed) crossbar
    # column group — crossbars executing the same program share a broadcast
    # message, so traffic is cycles x message_bits per wave.
    bits = waves * cycles * mult_cost(n_bits, model, geom)["msg_bits"]
    gpu_time = max(2.0 * m * k_dim * n / GPU_PEAK_FLOPS,
                   (m * k_dim + k_dim * n + m * n) * 2 / GPU_HBM_BW)
    return GemmCost(model=model, n_bits=n_bits, m=m, k_dim=k_dim, n=n,
                    crossbars=busy, waves=waves, cycles_per_wave=cycles,
                    time_s=time_s, energy_j=energy_j, control_bits=bits,
                    gpu_time_s=gpu_time, n_cols=geom, chunks=n_chunks)
