"""Public entry point for the crossbar executor kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.crossbar_exec.crossbar_exec import (
    crossbar_exec, crossbar_exec_ref)

__all__ = ["run_program", "crossbar_exec", "crossbar_exec_ref"]


def run_program(state: torch.Tensor, microcode, backend: str = "scan"
                ) -> torch.Tensor:
    """Execute a Program's microcode on crossbar state.

    Thin shim over the ``repro_torch.pim.engine`` backend registry —
    ``"scan"`` (alias ``"jnp"``, the per-gate oracle), ``"unrolled"``,
    ``"numpy"`` (these host oracles take a CPU state only), or ``"cuda"``
    (the CUDA kernel; a CUDA state only);
    ``engine.register_backend`` extends the set without touching call
    sites.
    """
    from repro_torch.pim import engine

    return engine.execute_state(state, microcode, backend=backend)
