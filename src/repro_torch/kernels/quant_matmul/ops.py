"""Quantized linear op: symmetric per-channel int8, PIM-faithful rounding."""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_matmul.quant_matmul import (
    quant_matmul_int, quant_matmul_int_ref)
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
from repro_torch.runtime.trace import span

__all__ = ["quantize_sym", "quant_linear", "quant_matmul_int",
           "quant_matmul_ref", "quant_matmul_int_ref"]


def quantize_sym(x: torch.Tensor, axis: int, bits: int = 8, amax=None):
    """Symmetric per-channel quantization -> (int8 values, f32 scales).

    ``amax`` overrides the per-channel abs-max (keepdims shape).  The
    conventions are the reference's: eps ``1e-8``, round half to even,
    clip to +-qmax."""
    qmax = 2 ** (bits - 1) - 1
    if amax is None:
        amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, torch.squeeze(scale, dim=axis).to(torch.float32)


def quant_linear(x: torch.Tensor, w: torch.Tensor, bits: int = 8
                 ) -> torch.Tensor:
    """y = x @ w via int8 fixed point. x: (..., K) f32/bf16, w: (K, N).

    The integer product is :func:`quant_matmul_int`: the CUDA kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    with span("linear.quantize"):
        x2 = x.reshape(-1, k).to(torch.float32)
        xq, xs = quantize_sym(x2, axis=1, bits=bits)
        wq, ws = quantize_sym(w.to(torch.float32), axis=0, bits=bits)
    with span("quant.gemm"):
        acc = quant_matmul_int(xq, wq)
    with span("linear.rescale"):
        y = acc.to(torch.float32) * xs[:, None] * ws[None, :]
        return y.reshape(*lead, w.shape[1]).to(x.dtype)
