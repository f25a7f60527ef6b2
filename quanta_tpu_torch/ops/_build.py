"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

At first CUDA use, every ``quanta_tpu_torch/csrc/*.cu`` is compiled by
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. Nothing includes PyTorch's headers, so
the build takes seconds. The library lands in
``quanta_tpu_torch/_build/<hash of the sources>/``, so an edited source
builds anew and an unchanged one is reused.

Every C entry point takes its pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()`` after the launch; :func:`check` raises
when it is not 0. A launch refused for its configuration never runs, and a
later ``torch.cuda.synchronize()`` would not report it.

``launches`` counts, per kernel, the launches its wrapper made; callers
reset it to see whether a run went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argtypes (pointers and the stream as void*, sizes as int)
_SIGNATURES = {
    # x, codes, scales, levels, out, M, N, K2, block, stream
    "qt_matmul_4bit_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "qt_matmul_4bit_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # g, codes, scales, levels, out, M, N, K2, block, stream
    "qt_matmul_4bit_t_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "qt_matmul_4bit_t_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, codes, scales, levels, out, M, N, K, block, stream
    "qt_matmul_8bit_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "qt_matmul_8bit_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # g, codes, scales, levels, out, M, N, K, block, stream
    "qt_matmul_8bit_t_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "qt_matmul_8bit_t_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # xq, codes, row_scale, col_scale, out, M, N, K2, stream
    "qt_matmul_int4c": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x (f32), codes, row_scale, col_scale, y_out, xq scratch (int8 (M, K)), out, M, N, K,
    # stream
    "qt_matmul_int8_fused": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # xq, codes, row_scale, col_scale, out, M, N, K, stream
    "qt_matmul_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, codes, scale, midpoints, n, block, n_blocks, n_mids, stream
    "qt_quantize_blockwise_f32": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
    "qt_quantize_blockwise_bf16": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
    # K, V, rows, k codes, v codes, k scales, v scales, L, R, nkv, hd, pool rows, stream
    "qt_kv_write_int8_f32": [_P] * 7 + [_I] * 4 + [_L, _P],
    "qt_kv_write_int8_bf16": [_P] * 7 + [_I] * 4 + [_L, _P],
    # leaves (host array of ops.adam8bit.AdamLeaf), n_leaves, (lr, bc1, bc2) on the device,
    # b1, b2, 1 - b1, 1 - b2, eps, lr * weight_decay, stream
    "qt_adam8bit_step": [_P, _I, _P] + [_F] * 6 + [_P],
    "qt_adam8bit_table_leaves": [],
    # q, k, v, q_start, kv_len, out, lse (or null), B, Sq, T, nh, nkv, hd, causal, scale, stream
    "qt_flash_fwd_bf16": [_P] * 7 + [_I] * 7 + [_F, _P],
    "qt_flash_fwd_f32": [_P] * 7 + [_I] * 7 + [_F, _P],
    # q, k, v, dO, lse, D, q_start, kv_len, dq, B, Sq, T, nh, nkv, hd, causal, scale, stream
    "qt_flash_bwd_dq_bf16": [_P] * 9 + [_I] * 7 + [_F, _P],
    "qt_flash_bwd_dq_f32": [_P] * 9 + [_I] * 7 + [_F, _P],
    # ... dk, dv, B, Sq, T, nh, nkv, hd, causal, scale, stream
    "qt_flash_bwd_dkv_bf16": [_P] * 10 + [_I] * 7 + [_F, _P],
    "qt_flash_bwd_dkv_f32": [_P] * 10 + [_I] * 7 + [_F, _P],
    # dkv (0: dQ, 1: dK/dV), hd, B, Sq, T, nh, nkv, out (int[11])
    "qt_flash_bwd_design": [_I] * 7 + [_P],
    "qt_flash_bwd_f32_design": [_I] * 7 + [_P],
    # hd, B, Sq, nh, out (int[10])
    "qt_flash_fwd_design": [_I] * 4 + [_P],
    "qt_flash_fwd_f32_design": [_I] * 4 + [_P],
    # M, N, K, out (int[11])
    "qt_matmul_8bit_design": [_I] * 3 + [_P],
    "qt_matmul_8bit_f32_design": [_I] * 3 + [_P],
    "qt_matmul_8bit_t_design": [_I] * 3 + [_P],
    "qt_matmul_8bit_t_f32_design": [_I] * 3 + [_P],
    # M, N, K2, out (int[11])
    "qt_matmul_4bit_design": [_I] * 3 + [_P],
    "qt_matmul_4bit_f32_design": [_I] * 3 + [_P],
    "qt_matmul_4bit_t_design": [_I] * 3 + [_P],
    "qt_matmul_4bit_t_f32_design": [_I] * 3 + [_P],
    "qt_matmul_int4c_design": [_I] * 3 + [_P],
    # M, N, K, fused, out (int[11])
    "qt_matmul_int8_design": [_I] * 4 + [_P],
}

# the 256-column flash kernels (csrc/*_w256.cu) take the same arguments
_SIGNATURES.update({f"{name}_w256": args for name, args in list(_SIGNATURES.items())
                    if name.startswith("qt_flash_")})

launches: dict[str, int] = {"matmul_4bit": 0, "matmul_4bit_t": 0, "matmul_8bit": 0,
                            "matmul_8bit_t": 0, "matmul_int4c": 0,
                            "matmul_int8_fused": 0, "matmul_int8": 0, "quantize_blockwise": 0,
                            "adam8bit_update": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if os.path.isfile("/usr/local/cuda/bin/nvcc") else None)
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build quanta_tpu_torch's CUDA kernels")
    return found


def _build() -> pathlib.Path:
    srcs = _sources()
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libquanta_kernels.so"
    if so.is_file():
        build_info.update(so=str(so), cached=True)
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # one nvcc per source, all at once; then one link. Temporary names,
    # renamed at the end: a reader never sees half a file.
    tmp = pathlib.Path(tempfile.mkdtemp(dir=out_dir))
    cus = [p for p in srcs if p.suffix == ".cu"]
    objs = [tmp / (p.stem + ".o") for p in cus]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for p, o in zip(cus, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [(p.name, proc.returncode, log) for p, proc, log in zip(cus, procs, logs)
              if proc.returncode != 0]
    if failed:
        shutil.rmtree(tmp)
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{log}" for name, rc, log in failed))
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / so.name), *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        shutil.rmtree(tmp)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp / so.name, so)
    shutil.rmtree(tmp)
    log = "".join(logs) + proc.stderr + proc.stdout
    (out_dir / "build.log").write_text(log)
    build_info.update(so=str(so), cached=False, ptxas=log)
    return so


def library() -> ctypes.CDLL:
    """The kernels' shared library, built and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.qt_error_string.argtypes = [ctypes.c_int]
            lib.qt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().qt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def use_kernel_for(use_kernel: bool | None, t) -> bool:
    """Dispatch rule shared by the kernel wrappers: None means "the kernel
    if the tensor is on CUDA"; True on a CPU tensor raises; False runs the
    plain version (on CUDA only to compare the kernel with it)."""
    if use_kernel is None:
        return t.is_cuda
    if use_kernel and not t.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor: the CUDA kernels "
                         f"have no CPU mode (got a tensor on {t.device})")
    return bool(use_kernel)


def refuse_grad(x, name: str, why: str) -> None:
    """Raise where a kernel's output would silently cut the gradient.

    A wrapper's output comes from ``torch.empty`` filled by a ctypes call,
    so it has no ``grad_fn``: under autograd, whatever ``x`` depends on
    would get no gradient and no error. Kernel routes without a backward
    call this with the tensor they read (the JAX package raises there too:
    ``jax.grad`` has no rule through a bare ``pallas_call``)."""
    import torch

    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(f"{name}: the CUDA kernel has no backward, and its output "
                                  f"would carry no gradient to x; {why}")
