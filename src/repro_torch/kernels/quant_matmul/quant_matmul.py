"""int8 x int8 -> int32 GEMM: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/quant_matmul/
quant_matmul.py::quant_matmul_int``.  The kernel is ``csrc/quant_matmul.cu``
(its source note gives the bound and the design).  :func:`quant_matmul_int`
runs :func:`quant_matmul_int_ref` for CPU tensors and launches the kernel
for CUDA tensors; ``quant_matmul_int.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["quant_matmul_int", "quant_matmul_int_ref"]


def quant_matmul_int_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.

    A float64 product is exact here: every term is below 2**14 and
    |sum| <= 128**2 * K < 2**53 for any K below 5e8."""
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def _lib():
    from repro_torch.kernels import build

    lib = build.load("quant_matmul")
    if not getattr(lib, "_typed", False):
        lib.quant_matmul_int_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.quant_matmul_int_launch.restype = ctypes.c_int
        lib.quant_matmul_error_string.argtypes = [ctypes.c_int]
        lib.quant_matmul_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def quant_matmul_int(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (or raise)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected (M, K) @ (K, N), got {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"expected int8 operands, got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if x.device.type == "cpu":
        return quant_matmul_int_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("quant_matmul_int needs contiguous operands")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quant_matmul_int_launch(x.data_ptr(), w.data_ptr(),
                                          out.data_ptr(), m, n, k, stream)
    if err:
        raise RuntimeError("quant_matmul_int launch failed: "
                           + lib.quant_matmul_error_string(err).decode())
    quant_matmul_int.launches += 1
    return out


quant_matmul_int.launches = 0
