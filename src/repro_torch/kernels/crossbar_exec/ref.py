"""Plain oracle for the crossbar microcode executor kernel, at the
reference's import path: ``crossbar_exec_ref`` runs the microcode one gate
at a time over the whole state (it lives beside the kernel's wrapper in
``crossbar_exec.py``)."""
from repro_torch.kernels.crossbar_exec.crossbar_exec import crossbar_exec_ref

__all__ = ["crossbar_exec_ref"]
