from repro_torch.kernels.quant_matmul.ops import (
    quant_linear, quant_matmul_int, quant_matmul_int_ref, quant_matmul_ref,
    quantize_sym)

__all__ = ["quant_linear", "quant_matmul_int", "quant_matmul_int_ref",
           "quant_matmul_ref", "quantize_sym"]
