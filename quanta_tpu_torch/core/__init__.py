"""Plain-torch quantization core (the port's reference path)."""

from quanta_tpu_torch.core.codebooks import codebook_names, get_codebook, get_midpoints
from quanta_tpu_torch.core.codecs import (
    dequantize,
    dequantize_matmul_weight,
    quantize,
    quantize_matmul_weight,
)
from quanta_tpu_torch.core.packing import (
    pack_nibbles,
    pack_split_k,
    unpack_nibbles,
    unpack_split_k,
)
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.core.tensor_ops import (
    quantized_add,
    quantized_matmul,
    quantized_mul,
    quantized_relu,
)

__all__ = [
    "QuantizedTensor",
    "quantize",
    "dequantize",
    "quantize_matmul_weight",
    "dequantize_matmul_weight",
    "get_codebook",
    "get_midpoints",
    "codebook_names",
    "pack_nibbles",
    "unpack_nibbles",
    "pack_split_k",
    "unpack_split_k",
    "quantized_add",
    "quantized_mul",
    "quantized_matmul",
    "quantized_relu",
]
