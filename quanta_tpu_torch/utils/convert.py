"""Precision conversion and hardware-target presets (port of
``quanta_tpu/utils/convert.py``).

Conversion is a dequantize -> requantize round trip through float that
gives a new ``QuantizedTensor`` under the target settings;
``transcode_codebook`` remaps codes between two codebooks of one bit width
without the round trip. Codes and scales are bit for bit the JAX
package's. ``HARDWARE_TARGETS`` is the JAX package's table, kept as data:
each row names a quantization format, not a device this port runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from quanta_tpu_torch.calib import _map_with_path
from quanta_tpu_torch.core import codebooks as _cb
from quanta_tpu_torch.core.codecs import dequantize, quantize
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.state.config import QuantConfig


def convert_precision(
    qt: QuantizedTensor,
    *,
    bits: Optional[int] = None,
    scheme: Optional[str] = None,
    codebook: Optional[str] = None,
    block_size: Optional[int] = None,
    pack: Optional[bool] = None,
) -> QuantizedTensor:
    """Requantize ``qt`` under new settings (fp round trip).

    Unspecified fields keep the source tensor's values, except
    ``codebook``, which resets when the scheme or bit width changes (an
    nf4 codebook means nothing to an 8-bit target).
    """
    new_bits = bits if bits is not None else qt.bits
    new_scheme = scheme if scheme is not None else qt.scheme
    if codebook is None and (new_bits != qt.bits or new_scheme != qt.scheme):
        new_codebook = None
    else:
        new_codebook = codebook if codebook is not None else qt.codebook
    new_block = block_size if block_size is not None else qt.block_size
    new_pack = pack if pack is not None else (new_bits == 4 and qt.packed != "none")
    return quantize(dequantize(qt), bits=new_bits, scheme=new_scheme, codebook=new_codebook,
                    block_size=new_block, pack=new_pack)


def transcode_codebook(qt: QuantizedTensor, target: str = "nf4a") -> QuantizedTensor:
    """Remap codes between two codebooks of one bit width (exact NF4 ->
    nf4a, say) without an fp round trip.

    Both codebooks are absmax-normalized, so the block scales carry over
    and the transcode is a code lookup: each source code maps to the
    target level nearest its source level, which is what dequantize ->
    requantize at the same block size gives, but in O(bytes) and valid on
    packed matmul-layout tensors. Checkpoints quantized by QLoRA arrive as
    exact NF4; this lets them run nf4a's kernel designs.
    """
    if qt.codebook is None:
        raise ValueError("transcode_codebook needs a codebook-format tensor")
    for name in (qt.codebook, target):
        if name not in _cb.codebook_names():
            raise ValueError(f"unknown codebook {name!r}")
    src = np.asarray(_cb._REGISTRY[qt.codebook], np.float32)
    dst = np.asarray(_cb._REGISTRY[target], np.float32)
    if len(src) != len(dst):
        raise ValueError(f"codebook sizes differ: {qt.codebook}={len(src)} vs "
                         f"{target}={len(dst)}")
    remap = np.argmin(np.abs(dst[None, :] - src[:, None]), axis=1)
    remap = torch.from_numpy(remap.astype(np.uint8)).to(qt.codes.device)
    if qt.packed != "none":  # two codes a byte (split_k or flat): remap each nibble
        codes = remap[(qt.codes & 0x0F).long()] | (remap[(qt.codes >> 4).long()] << 4)
    else:
        # one code a byte, the high nibble 0: remapping that nibble would
        # corrupt every code wherever remap[0] != 0
        codes = remap[qt.codes.long()]
    return dataclasses.replace(qt, codes=codes, codebook=target)


def transcode_params(params, target: str = "nf4a", source: str = "nf4"):
    """Tree version: remap every ``source``-codebook QuantizedTensor leaf
    to ``target`` (the load-time path for imported QLoRA/NF4
    checkpoints; see ``transcode_codebook``)."""

    def conv(_path, leaf):
        if isinstance(leaf, QuantizedTensor) and leaf.codebook == source:
            return transcode_codebook(leaf, target)
        return leaf

    return _map_with_path(conv, params)


def convert_8bit_to_4bit(qt: QuantizedTensor, **kw) -> QuantizedTensor:
    return convert_precision(qt, bits=4, **kw)


def convert_4bit_to_8bit(qt: QuantizedTensor, **kw) -> QuantizedTensor:
    return convert_precision(qt, bits=8, **kw)


# the JAX package's table, row for row
HARDWARE_TARGETS = {
    "tpu": QuantConfig(bits=4, scheme="codebook", codebook="nf4", block_size=64, pack=True),
    "cpu": QuantConfig(bits=8, scheme="affine", block_size=0),
    "gpu": QuantConfig(bits=8, scheme="symmetric", block_size=64),
    "mobile": QuantConfig(bits=4, scheme="codebook", codebook="nf4", block_size=64, pack=True),
    "edge": QuantConfig(bits=4, scheme="symmetric", block_size=64, pack=True),
}


def optimize_for_target_hardware(qt: QuantizedTensor, target: str = "tpu") -> QuantizedTensor:
    """Requantize under a row of ``HARDWARE_TARGETS``."""
    if target not in HARDWARE_TARGETS:
        raise ValueError(f"unknown target {target!r}; options: {sorted(HARDWARE_TARGETS)}")
    c = HARDWARE_TARGETS[target]
    return convert_precision(qt, bits=c.bits, scheme=c.scheme, codebook=c.codebook,
                             block_size=c.block_size, pack=c.pack)
