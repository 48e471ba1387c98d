from repro_torch.kernels.crossbar_exec.crossbar_exec import (
    Plan, check_microcode, crossbar_exec, crossbar_exec_grouped_ref,
    crossbar_exec_ref, plan)

__all__ = ["Plan", "check_microcode", "crossbar_exec",
           "crossbar_exec_grouped_ref", "crossbar_exec_ref", "plan"]
