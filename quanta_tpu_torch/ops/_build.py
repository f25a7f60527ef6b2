"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

At first CUDA use, every ``quanta_tpu_torch/csrc/*.cu`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, and loaded with ``ctypes``. Nothing includes PyTorch's headers,
so the build takes seconds. The library lands in
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

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes (pointers and the stream as void*, sizes as int)
_SIGNATURES = {
    # x, codes, scales, levels, out, M, N, K2, block, stream
    "qt_matmul_4bit_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "qt_matmul_4bit_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # xq, codes, row_scale, col_scale, out, M, N, K2, stream
    "qt_matmul_int4c": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}

launches: dict[str, int] = {"matmul_4bit": 0, "matmul_int4c": 0}

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
    cus = [str(p) for p in srcs if p.suffix == ".cu"]
    # build to a temporary name, then rename: a reader never sees half a file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cus]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, so)
    (out_dir / "build.log").write_text(proc.stderr + proc.stdout)
    build_info.update(so=str(so), cached=False, ptxas=proc.stderr + proc.stdout)
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
