"""Packing, serialization and precision conversion (port of quanta_tpu/utils)."""

from quanta_tpu_torch.core.packing import pack_nibbles, unpack_nibbles
from quanta_tpu_torch.utils.convert import (
    HARDWARE_TARGETS,
    convert_4bit_to_8bit,
    convert_8bit_to_4bit,
    convert_precision,
    optimize_for_target_hardware,
    transcode_codebook,
    transcode_params,
)
from quanta_tpu_torch.utils.serialization import (
    checkpoint_nbytes,
    load_checkpoint,
    load_npz,
    load_qtn,
    load_quantized_tensor,
    save_checkpoint,
    save_npz,
    save_qtn,
    save_quantized_tensor,
)

__all__ = [
    "pack_nibbles",
    "unpack_nibbles",
    "convert_precision",
    "convert_8bit_to_4bit",
    "convert_4bit_to_8bit",
    "optimize_for_target_hardware",
    "transcode_codebook",
    "transcode_params",
    "HARDWARE_TARGETS",
    "save_qtn",
    "load_qtn",
    "save_npz",
    "load_npz",
    "save_quantized_tensor",
    "load_quantized_tensor",
    "save_checkpoint",
    "load_checkpoint",
    "checkpoint_nbytes",
]
