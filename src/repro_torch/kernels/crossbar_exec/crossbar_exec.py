"""Crossbar microcode executor: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/crossbar_exec/
crossbar_exec.py::crossbar_exec``.  The kernel is ``csrc/crossbar_exec.cu``
(its source note gives the bound and the design).  State is ``(C, n, W)``
int32 holding the bits of the reference's uint32 words; microcode is
``(G, 4)`` int32 rows ``(code, ia, ib, dst)`` with codes 0 INIT, 1 NOT,
2 NOR, 3 OR, 4 NAND, 5 AND.  :func:`crossbar_exec` runs
:func:`crossbar_exec_ref` for CPU tensors and launches the kernel for CUDA
tensors; ``crossbar_exec.launches`` counts the launches.
"""
from __future__ import annotations

import collections
import ctypes

import torch

__all__ = ["crossbar_exec", "crossbar_exec_ref", "check_microcode"]


def crossbar_exec_ref(state: torch.Tensor, microcode: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version: a per-gate loop over the microcode rows.

    Works on a ``(n, C, W)`` copy of the state so that every column is one
    contiguous view; each gate is one or two in-place bitwise ops."""
    st = state.permute(1, 0, 2).contiguous()
    cols = st.unbind(0)
    for code, ia, ib, dst in microcode.tolist():
        out = cols[dst]
        if code == 0:                       # INIT
            out.fill_(-1)
        elif code == 1:                     # NOT
            torch.bitwise_not(cols[ia], out=out)
        elif code == 2:                     # NOR
            torch.bitwise_or(cols[ia], cols[ib], out=out)
            out.bitwise_not_()
        elif code == 3:                     # OR
            torch.bitwise_or(cols[ia], cols[ib], out=out)
        elif code == 4:                     # NAND
            torch.bitwise_and(cols[ia], cols[ib], out=out)
            out.bitwise_not_()
        else:                               # AND
            torch.bitwise_and(cols[ia], cols[ib], out=out)
    return st.permute(1, 0, 2).contiguous()


# microcode already validated for a column count: (identity) -> tensor.  The
# entry holds the tensor, so its address cannot be reused while it is here.
_validated: "collections.OrderedDict" = collections.OrderedDict()
_VALIDATED_MAX = 64


def check_microcode(microcode: torch.Tensor, n: int) -> None:
    """Raise unless every row has a code in 0..5 and columns in [0, n)."""
    if microcode.dim() != 2 or microcode.shape[1] != 4:
        raise ValueError(f"microcode must be (G, 4), got "
                         f"{tuple(microcode.shape)}")
    if microcode.shape[0] == 0:
        return
    codes, cols = microcode[:, 0], microcode[:, 1:]
    if bool(((codes < 0) | (codes > 5)).any()):
        raise ValueError("microcode holds a gate code outside 0..5")
    if bool(((cols < 0) | (cols >= n)).any()):
        raise ValueError(f"microcode addresses a column outside [0, {n})")


def _lib():
    from repro_torch.kernels import build

    lib = build.load("crossbar_exec")
    if not getattr(lib, "_typed", False):
        lib.crossbar_exec_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.crossbar_exec_launch.restype = ctypes.c_int
        lib.crossbar_exec_error_string.argtypes = [ctypes.c_int]
        lib.crossbar_exec_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def crossbar_exec(state: torch.Tensor, microcode: torch.Tensor
                  ) -> torch.Tensor:
    """Run microcode (G, 4) int32 over state (C, n, W) int32 -> new state.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (or raise).  The microcode's columns are checked
    against ``n`` once per microcode tensor."""
    if state.dim() != 3:
        raise ValueError(f"state must be (C, n, W), got {tuple(state.shape)}")
    if state.dtype != torch.int32 or microcode.dtype != torch.int32:
        raise TypeError(f"expected int32 state and microcode, got "
                        f"{state.dtype}, {microcode.dtype}")
    if state.device != microcode.device:
        raise ValueError(f"state on {state.device}, microcode on "
                         f"{microcode.device}")
    c, n, w = state.shape
    key = (microcode.device, microcode.data_ptr(), microcode._version,
           tuple(microcode.shape), n)
    if key not in _validated:
        check_microcode(microcode, n)
        _validated[key] = microcode
        while len(_validated) > _VALIDATED_MAX:
            _validated.popitem(last=False)
    if state.device.type == "cpu":
        return crossbar_exec_ref(state, microcode)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    if not (state.is_contiguous() and microcode.is_contiguous()):
        raise ValueError("crossbar_exec needs contiguous state and microcode")
    if microcode.data_ptr() % 16:
        raise ValueError("crossbar_exec reads microcode rows as int4: it "
                         "must start on a 16-byte boundary")
    out = torch.empty_like(state)
    if c == 0:
        return out
    lib = _lib()
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.crossbar_exec_launch(microcode.data_ptr(),
                                       microcode.shape[0], state.data_ptr(),
                                       out.data_ptr(), c, n, w, stream)
    if err:
        raise RuntimeError("crossbar_exec launch failed: "
                           + lib.crossbar_exec_error_string(err).decode())
    crossbar_exec.launches += 1
    return out


crossbar_exec.launches = 0
