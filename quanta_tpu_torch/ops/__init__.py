"""Hand-written CUDA kernels + dispatch (port of quanta_tpu/ops).

Each kernel lives in ``quanta_tpu_torch/csrc/`` and is built at first CUDA
use (``ops/_build.py``); beside each wrapper sits a plain-torch version of
the same function. Dispatch: the kernel for CUDA tensors, the plain version
for CPU tensors.
"""

from quanta_tpu_torch.ops.adam8bit import adam8bit_update
from quanta_tpu_torch.ops.attention import flash_attention
from quanta_tpu_torch.ops.int4c import Int4cWeight, matmul_int4c, quantize_int4c_weight
from quanta_tpu_torch.ops.int8mm import (
    Int8Weight,
    matmul_int8,
    matmul_int8_fused,
    matmul_int8_kernel,
    outlier_coverage,
    quantize_int8_weight,
)
from quanta_tpu_torch.ops.matmul import (
    matmul_4bit,
    matmul_4bit_t,
    matmul_8bit,
    matmul_8bit_t,
    matmul_quantized,
)
from quanta_tpu_torch.ops.quantize import dequantize_blockwise, quantize_blockwise

__all__ = [
    "matmul_quantized",
    "matmul_4bit",
    "matmul_4bit_t",
    "matmul_8bit",
    "matmul_8bit_t",
    "adam8bit_update",
    "flash_attention",
    "Int4cWeight",
    "matmul_int4c",
    "quantize_int4c_weight",
    "Int8Weight",
    "matmul_int8",
    "matmul_int8_fused",
    "matmul_int8_kernel",
    "outlier_coverage",
    "quantize_int8_weight",
    "quantize_blockwise",
    "dequantize_blockwise",
]
