"""Hand-written CUDA kernels + dispatch (port of quanta_tpu/ops).

Each kernel lives in ``quanta_tpu_torch/csrc/`` and is built at first CUDA
use (``ops/_build.py``); beside each wrapper sits a plain-torch version of
the same function. Dispatch: the kernel for CUDA tensors, the plain version
for CPU tensors.
"""

from quanta_tpu_torch.ops.int4c import Int4cWeight, matmul_int4c, quantize_int4c_weight
from quanta_tpu_torch.ops.matmul import matmul_4bit, matmul_quantized

__all__ = [
    "matmul_quantized",
    "matmul_4bit",
    "Int4cWeight",
    "matmul_int4c",
    "quantize_int4c_weight",
]
