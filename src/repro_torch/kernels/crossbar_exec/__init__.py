from repro_torch.kernels.crossbar_exec.crossbar_exec import (
    check_microcode, crossbar_exec, crossbar_exec_ref)

__all__ = ["check_microcode", "crossbar_exec", "crossbar_exec_ref"]
