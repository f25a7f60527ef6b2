"""Persistence of quantized tensors and whole parameter trees (port of
``quanta_tpu/utils/serialization.py``); every file is in the JAX package's
format, so what either package writes the other reads.

Single tensors, two formats:

- ``.qtn``: ``QTN1``, an 8-byte little-endian header length, the JSON
  metadata (bits, scheme, codebook, shape, dtype, block size, packing and
  the dtype and shape of every payload array), then the raw bytes of the
  codes, the scales and the zero points. The header is the JAX package's
  JSON, key for key, so the two write the same bytes.
- ``.npz``: the same metadata under ``__meta__`` beside ``codes``,
  ``scale`` and ``zero_point``.

Trees: one ``.npz`` file; the ``__tree__`` entry is JSON (version
3) with one metadata entry per leaf path ('/'-joined keys) and the kind of
every container (dict, list, tuple; empty ones too); each leaf's arrays
are stored under ``<path>.<field>``. Leaf kinds: ``qtensor``
(``QuantizedTensor``), ``int8weight``, ``int4cweight``, ``lora``
(``LoRAWeight``, recursing into its base), ``actquant``
(``ActQuantWeight``, recursing into its weight) and ``array``. npz cannot
hold bfloat16, so a bf16 tensor is stored as its uint16 bits with
``view_dtype: "bfloat16"`` in its entry. A ``TapWeight`` is saved as the
weight it wraps: taps are calibration-time instrumentation, not state.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from quanta_tpu_torch.calib import ActQuantWeight, TapWeight
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.interop import to_torch_dtype
from quanta_tpu_torch.nn.lora import LoRAWeight
from quanta_tpu_torch.ops.int4c import Int4cWeight
from quanta_tpu_torch.ops.int8mm import Int8Weight

_MAGIC = b"QTN1"

def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's name as the JAX package writes it ("bfloat16")."""
    return str(dtype).removeprefix("torch.")


def _np(t) -> np.ndarray:
    """A tensor (or scalar) as a numpy array on the host."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _meta(qt: QuantizedTensor) -> Dict[str, Any]:
    m = {
        "bits": qt.bits,
        "scheme": qt.scheme,
        "codebook": qt.codebook,
        "shape": list(qt.shape),
        "dtype": dtype_name(qt.dtype),
        "block_size": qt.block_size,
        "packed": qt.packed,
        "codes_dtype": dtype_name(qt.codes.dtype),
        "codes_shape": list(qt.codes.shape),
        "scale_dtype": dtype_name(qt.scale.dtype),
        "scale_shape": list(qt.scale.shape),
        "has_zp": qt.zero_point is not None,
    }
    if qt.zero_point is not None:
        m["zp_dtype"] = dtype_name(qt.zero_point.dtype)
        m["zp_shape"] = list(qt.zero_point.shape)
    return m


def _tensor(a: np.ndarray, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def _from_meta(m: Dict[str, Any], codes, scale, zp, device=None) -> QuantizedTensor:
    return QuantizedTensor(
        codes=_tensor(codes, device),
        scale=_tensor(scale, device),
        zero_point=None if zp is None else _tensor(zp, device),
        bits=m["bits"],
        scheme=m["scheme"],
        codebook=m["codebook"],
        shape=tuple(m["shape"]),
        dtype=to_torch_dtype(m["dtype"]),
        block_size=m["block_size"],
        packed=m["packed"],
    )


# ------------------------------------------------------------------- .qtn


def _read_array(f, shape, dtype: str) -> np.ndarray:
    dt = np.dtype(dtype)
    count = int(np.prod(shape))  # np.prod([]) == 1.0: a scalar
    return np.frombuffer(f.read(count * dt.itemsize), dtype=dt).reshape(shape)


def save_qtn(qt: QuantizedTensor, path: str) -> None:
    meta = json.dumps(_meta(qt)).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(len(meta).to_bytes(8, "little"))
        f.write(meta)
        f.write(np.ascontiguousarray(_np(qt.codes)).tobytes())
        f.write(np.ascontiguousarray(_np(qt.scale)).tobytes())
        if qt.zero_point is not None:
            f.write(np.ascontiguousarray(_np(qt.zero_point)).tobytes())


def load_qtn(path: str, device=None) -> QuantizedTensor:
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not a .qtn file")
        n = int.from_bytes(f.read(8), "little")
        m = json.loads(f.read(n))
        codes = _read_array(f, m["codes_shape"], m["codes_dtype"])
        scale = _read_array(f, m["scale_shape"], m.get("scale_dtype", "float32"))
        zp = _read_array(f, m["zp_shape"], m["zp_dtype"]) if m["has_zp"] else None
    return _from_meta(m, codes, scale, zp, device)


# ------------------------------------------------------------------- .npz


def save_npz(qt: QuantizedTensor, path: str) -> None:
    arrays = {"codes": _np(qt.codes), "scale": _np(qt.scale)}
    if qt.zero_point is not None:
        arrays["zero_point"] = _np(qt.zero_point)
    np.savez(path, __meta__=json.dumps(_meta(qt)), **arrays)


def load_npz(path: str, device=None) -> QuantizedTensor:
    with np.load(path, allow_pickle=False) as z:
        m = json.loads(str(z["__meta__"]))
        return _from_meta(m, z["codes"], z["scale"], z["zero_point"] if m["has_zp"] else None,
                          device)


def save_quantized_tensor(qt: QuantizedTensor, path: str) -> None:
    """Save by extension: ``.qtn`` or ``.npz``."""
    if path.endswith(".qtn"):
        save_qtn(qt, path)
    elif path.endswith(".npz"):
        save_npz(qt, path)
    else:
        raise ValueError(f"unsupported extension: {path} (use .qtn or .npz)")


def load_quantized_tensor(path: str, device=None) -> QuantizedTensor:
    if path.endswith(".qtn"):
        return load_qtn(path, device)
    if path.endswith(".npz"):
        return load_npz(path, device)
    raise ValueError(f"unsupported extension: {path} (use .qtn or .npz)")


# -------------------------------------------------------- tree checkpoints


def _flatten_tree(tree):
    """Flatten to ``{path: leaf}`` plus ``{path: container_kind}``.

    The container-kind map records, for every internal node (including the
    root at path ``""`` and *empty* containers), whether it was a dict,
    list, or tuple, so rebuilding never has to guess from key shapes."""
    flat: Dict[str, Any] = {}
    kinds: Dict[str, str] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            kinds[prefix] = "dict"
            for k, v in node.items():
                k = str(k)
                if "/" in k:
                    raise ValueError(f"tree key may not contain '/': {k!r}")
                walk(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            kinds[prefix] = "list" if isinstance(node, list) else "tuple"
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}" if prefix else str(i), v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat, kinds


def _put_array(arrays: Dict[str, np.ndarray], key: str, a) -> Dict[str, Any]:
    """Store one array under ``key``; returns its metadata (bf16 is stored
    as its uint16 bits, since npz cannot hold bfloat16)."""
    entry: Dict[str, Any] = {}
    if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
        entry["view_dtype"] = "bfloat16"
        arrays[key] = _np(a.view(torch.int16)).view(np.uint16)
    else:
        arrays[key] = _np(a)
    return entry


def _get_array(z, key: str, entry: Dict[str, Any], device=None) -> torch.Tensor:
    a = z[key]
    view = entry.get("view_dtype")
    if view is None:
        return _tensor(a, device)
    if view != "bfloat16":
        raise ValueError(f"{key}: unsupported view_dtype {view!r}")
    return _tensor(a.view(np.int16), device).view(torch.bfloat16)


def _save_leaf(name: str, leaf, arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Serialize one leaf (recursing into wrapper weights); returns its
    JSON-able metadata entry. Raises TypeError on a leaf type it does not
    know rather than pickle it (which load, with allow_pickle=False, could
    never read back)."""
    if isinstance(leaf, QuantizedTensor):
        entry: Dict[str, Any] = {"kind": "qtensor", **_meta(leaf)}
        arrays[f"{name}.codes"] = _np(leaf.codes)
        arrays[f"{name}.scale"] = _np(leaf.scale)
        if leaf.zero_point is not None:
            arrays[f"{name}.zp"] = _np(leaf.zero_point)
        return entry
    if isinstance(leaf, Int8Weight):
        entry = {"kind": "int8weight", "threshold": leaf.threshold, "shape": list(leaf.shape)}
        for field in ("codes", "scale", "outlier_idx", "w_outlier"):
            entry[field] = _put_array(arrays, f"{name}.{field}", getattr(leaf, field))
        return entry
    if isinstance(leaf, Int4cWeight):
        entry = {"kind": "int4cweight", "shape": list(leaf.shape)}
        for field in ("codes", "scale"):
            entry[field] = _put_array(arrays, f"{name}.{field}", getattr(leaf, field))
        return entry
    if isinstance(leaf, LoRAWeight):
        entry = {"kind": "lora", "alpha": leaf.alpha,
                 "base": _save_leaf(f"{name}.base", leaf.base, arrays)}
        entry["lora_a"] = _put_array(arrays, f"{name}.lora_a", leaf.lora_a)
        entry["lora_b"] = _put_array(arrays, f"{name}.lora_b", leaf.lora_b)
        return entry
    if isinstance(leaf, ActQuantWeight):
        entry = {"kind": "actquant", "bits": leaf.bits,
                 "w": _save_leaf(f"{name}.w", leaf.w, arrays)}
        entry["lo"] = _put_array(arrays, f"{name}.lo", leaf.lo)
        entry["hi"] = _put_array(arrays, f"{name}.hi", leaf.hi)
        return entry
    if isinstance(leaf, TapWeight):
        return _save_leaf(name, leaf.w, arrays)
    if isinstance(leaf, (torch.Tensor, np.ndarray)) or np.isscalar(leaf):
        entry = {"kind": "array"}
        entry.update(_put_array(arrays, f"{name}.a", leaf))
        return entry
    raise TypeError(
        f"checkpoint leaf {name!r} has unsupported type {type(leaf).__name__}; "
        "supported: tensor, QuantizedTensor, Int8Weight, Int4cWeight, LoRAWeight, "
        "ActQuantWeight, TapWeight")


def _load_leaf(name: str, m: Dict[str, Any], z, device=None):
    kind = m["kind"]
    if kind == "qtensor":
        return _from_meta(m, z[f"{name}.codes"], z[f"{name}.scale"],
                          z[f"{name}.zp"] if m["has_zp"] else None, device)
    if kind == "int8weight":
        return Int8Weight(
            codes=_get_array(z, f"{name}.codes", m["codes"], device),
            scale=_get_array(z, f"{name}.scale", m["scale"], device),
            outlier_idx=_get_array(z, f"{name}.outlier_idx", m["outlier_idx"], device),
            w_outlier=_get_array(z, f"{name}.w_outlier", m["w_outlier"], device),
            threshold=m["threshold"],
            shape=tuple(m["shape"]),
        )
    if kind == "int4cweight":
        return Int4cWeight(codes=_get_array(z, f"{name}.codes", m["codes"], device),
                           scale=_get_array(z, f"{name}.scale", m["scale"], device),
                           shape=tuple(m["shape"]))
    if kind == "lora":
        # adapters are the trainable leaves, as nn.init_lora makes them
        return LoRAWeight(
            base=_load_leaf(f"{name}.base", m["base"], z, device),
            lora_a=_get_array(z, f"{name}.lora_a", m["lora_a"], device).requires_grad_(),
            lora_b=_get_array(z, f"{name}.lora_b", m["lora_b"], device).requires_grad_(),
            alpha=m["alpha"],
        )
    if kind == "actquant":
        return ActQuantWeight(w=_load_leaf(f"{name}.w", m["w"], z, device),
                              lo=_get_array(z, f"{name}.lo", m["lo"], device),
                              hi=_get_array(z, f"{name}.hi", m["hi"], device),
                              bits=m["bits"])
    return _get_array(z, f"{name}.a", m, device)


def save_checkpoint(tree, path: str) -> None:
    """Save a (possibly quantized) parameter tree to one .npz file.

    Quantized leaves store their component arrays plus JSON metadata;
    tensor leaves store as arrays. Container kinds (dict vs list vs tuple)
    are recorded per path in the ``__tree__`` metadata, so the structure
    round-trips exactly, including dicts whose keys happen to be '0'..'n-1'
    and empty containers."""
    flat, kinds = _flatten_tree(tree)
    arrays: Dict[str, np.ndarray] = {}
    leaves: Dict[str, Any] = {}
    for name, leaf in flat.items():
        leaves[name] = _save_leaf(name, leaf, arrays)
    meta = {"version": 3, "leaves": leaves, "containers": kinds}
    np.savez(path, __tree__=json.dumps(meta), **arrays)


def load_checkpoint(path: str, device=None):
    """Load a checkpoint back into its original nested structure, its
    tensors on ``device`` (default: the CPU)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__tree__"]))
        kinds = meta["containers"]
        flat = {name: _load_leaf(name, m, z, device) for name, m in meta["leaves"].items()}

    if "" in flat:  # the tree was a bare leaf
        return flat[""]

    # a dict skeleton from the leaf paths and the (possibly empty) containers
    nested: Dict[str, Any] = {}
    for cpath in kinds:
        node = nested
        if cpath:
            for p in cpath.split("/"):
                node = node.setdefault(p, {})
    for name, leaf in flat.items():
        node = nested
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    # skeleton dicts to their recorded container kinds, bottom-up
    def convert(node, path):
        if not isinstance(node, dict):
            return node
        out = {k: convert(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        kind = kinds.get(path, "dict")
        if kind in ("list", "tuple"):
            seq = [out[str(i)] for i in range(len(out))]
            return tuple(seq) if kind == "tuple" else seq
        return out

    return convert(nested, "")


def checkpoint_nbytes(path: str) -> int:
    return os.path.getsize(path)
