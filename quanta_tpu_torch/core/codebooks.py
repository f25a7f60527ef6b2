"""Quantization codebooks (NF4 / NF8 / FP4 / FP8 / INT4 / INT8), numpy only.

Every non-uniform format is a *codebook*: a sorted vector of ``2**bits``
levels normalized to ``[-1, 1]``. Dequantization is
``codebook[codes] * scale``; quantization is nearest-level rounding by
``searchsorted`` over level midpoints.

The numbers are copies of ``quanta_tpu/core/codebooks.py`` (which imports
jax, so it cannot be imported here); ``tests/test_torch_core.py`` holds
every table bit-equal to that registry.

Polynomial codebooks ("nf4a", "int4", "int8") define their levels as the
float32 Horner evaluation of ``POLY_COEFFS`` at c = 0..2^bits-1. The CUDA
``matmul_4bit`` kernel reads the registered level table, so it gets those
exact float32 values without evaluating the polynomial itself.
"""

from __future__ import annotations

import functools

import numpy as np

# QLoRA NormalFloat-4 levels (exact bitsandbytes constants). Sorted
# ascending; index 7 is exactly 0.0.
NF4_LEVELS = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)


def _nf8_levels() -> np.ndarray:
    """256 tanh-warped levels over [-1, 1]."""
    lin = np.linspace(-1.0, 1.0, 256, dtype=np.float64)
    lv = np.tanh(lin * 2.0)
    lv = lv / np.abs(lv).max()
    return lv.astype(np.float32)


def _fp4_levels() -> np.ndarray:
    """e2m1 magnitudes {0, .5, 1, 1.5, 2, 3, 4, 6}/6 in both signs (16
    entries with a duplicate zero to keep the 4-bit code space)."""
    mags = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0]) / 6.0
    lv = np.concatenate([-mags[::-1], mags])
    return np.sort(lv).astype(np.float32)


def _fp8_e4m3_levels() -> np.ndarray:
    """256-entry e4m3 value table, absmax-normalized (max finite = 448)."""
    vals = []
    for s in (1.0, -1.0):
        for e in range(16):
            for m in range(8):
                if e == 0:  # subnormal
                    v = s * (m / 8.0) * 2.0 ** (-6)
                elif e == 15 and m == 7:  # NaN slot in e4m3fn -> clamp to max
                    v = s * 448.0
                else:
                    v = s * (1.0 + m / 8.0) * 2.0 ** (e - 7)
                vals.append(v)
    lv = np.sort(np.array(vals, dtype=np.float64) / 448.0)
    return lv.astype(np.float32)


def _int_levels(bits: int) -> np.ndarray:
    """Symmetric uniform grid as a degree-1 polynomial codebook:
    level(c) = (c - 2^(b-1)) / (2^(b-1) - 1)."""
    offset = 2.0 ** (bits - 1)
    qmax = offset - 1.0
    return _poly_levels((1.0 / qmax, -offset / qmax), 2**bits)


# Polynomial codebooks: {name: coefficients, highest degree first}.
POLY_COEFFS: dict[str, tuple] = {
    "nf4a": (
        0.0006303362129204599,
        -0.014194327019966578,
        0.19776771619397554,
        -0.9496551767520744,
    ),
    "int4": (1.0 / 7.0, -8.0 / 7.0),
    "int8": (1.0 / 127.0, -128.0 / 127.0),
}


def _poly_levels(coeffs, n: int) -> np.ndarray:
    """f32 Horner evaluation at c = 0..n-1. numpy rounds each multiply and
    add separately (no fused multiply-add), as the reference levels do."""
    c = np.arange(n, dtype=np.float32)
    out = np.full(n, np.float32(coeffs[0]), np.float32)
    for a in coeffs[1:]:
        out = out * c + np.float32(a)
    return out


_REGISTRY: dict[str, np.ndarray] = {}


def _register(name: str, levels: np.ndarray) -> None:
    assert levels.ndim == 1 and np.all(np.diff(levels) >= 0)
    _REGISTRY[name] = levels


_register("nf4", NF4_LEVELS)
_register("nf4a", _poly_levels(POLY_COEFFS["nf4a"], 16))
_register("nf8", _nf8_levels())
_register("fp4", _fp4_levels())
_register("fp8", _fp8_e4m3_levels())
_register("int4", _int_levels(4))
_register("int8", _int_levels(8))


def codebook_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get_poly_coeffs(name: str):
    """Horner coefficients (highest first) if ``name`` is polynomial."""
    return POLY_COEFFS.get(name)


def get_levels(name: str) -> np.ndarray:
    """The numpy master copy of the sorted levels (do not mutate)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown codebook {name!r}; have {codebook_names()}")
    return _REGISTRY[name]


@functools.lru_cache(maxsize=None)
def _midpoints_np(name: str) -> np.ndarray:
    lv = _REGISTRY[name]
    return (lv[1:] + lv[:-1]) / 2.0


def get_midpoints_np(name: str) -> np.ndarray:
    """Decision boundaries between adjacent levels (len 2^bits-1)."""
    get_levels(name)
    return _midpoints_np(name)


def bits_of(name: str) -> int:
    return int(np.log2(len(_REGISTRY[name])))


# Torch views of the tables, built per call (cheap: at most 256 entries) so
# no device tensor is cached at module level.


def get_codebook(name: str, device=None):
    """Sorted codebook levels as an f32 torch tensor on ``device``."""
    import torch

    return torch.tensor(get_levels(name), dtype=torch.float32, device=device)


def get_midpoints(name: str, device=None):
    """Midpoints as an f32 torch tensor on ``device``."""
    import torch

    return torch.tensor(get_midpoints_np(name), dtype=torch.float32, device=device)
