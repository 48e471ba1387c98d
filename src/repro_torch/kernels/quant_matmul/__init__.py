from repro_torch.kernels.quant_matmul.ops import (
    quant_linear, quant_matmul_int, quant_matmul_int_ref, quant_matmul_ref,
    quantize_sym)
from repro_torch.kernels.quant_matmul.tp import (tp_quant_linear,
                                                 tp_quant_linear_ref,
                                                 tp_split, tp_tile_shape)

__all__ = ["quant_linear", "quant_matmul_int", "quant_matmul_int_ref",
           "quant_matmul_ref", "quantize_sym", "tp_quant_linear",
           "tp_quant_linear_ref", "tp_split", "tp_tile_shape"]
