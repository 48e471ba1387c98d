"""Plain oracles for the fixed-point (int8) matmul kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul_int_ref

__all__ = ["quant_matmul_ref", "quant_matmul_int_ref"]


def quant_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                     x_scale: torch.Tensor, w_scale: torch.Tensor
                     ) -> torch.Tensor:
    """x: (M, K) int8, w: (K, N) int8, scales per row/col -> (M, N) f32."""
    acc = quant_matmul_int_ref(x, w)
    return acc.to(torch.float32) * x_scale[:, None] * w_scale[None, :]
