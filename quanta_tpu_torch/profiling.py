"""Profiling and roofline accounting on the CUDA device (port of
``quanta_tpu/profiling.py``, in PyTorch's idiom).

  - ``DeviceSpec`` / ``device_spec``: the published rates of the device the
    port runs on, an NVIDIA H100 (SXM, dense, at its 700 W limit; NVIDIA's
    data sheet), the rates ``chip_smoke.py`` bounds its kernels by. They
    are the card's published peaks, not measurements. The ``cpu`` row is
    nominal, so accounting resolves on a CPU run; it times nothing.
  - ``measure``: seconds per call of a function on the CUDA device, from
    CUDA events around many calls, queued while the device spins, so the
    events time the calls back to back and not the host between them.
  - ``matmul_roofline`` / ``decode_step_roofline``: bytes moved and
    operations of a (possibly quantized) matmul or Llama decode step,
    against the device's memory rate and peak.
  - ``trace``: ``torch.profiler`` over a block, its chrome trace written
    to a directory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable

import torch

# ~50 ms of SM clock: the device spins while the host queues the timed calls
_SLEEP_CYCLES = 10**8


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    hbm_gbps: float     # device memory rate, GB/s
    bf16_tflops: float  # tensor-core peak, bf16 (dense)
    int8_tops: float    # tensor-core peak, int8 (dense)
    f32_tflops: float   # f32 outside the tensor cores


H100 = DeviceSpec("H100", 3350.0, 989.0, 1979.0, 67.0)
_DEVICE_TABLE = {
    "h100": H100,
    "cpu": DeviceSpec("cpu", 50.0, 1.0, 2.0, 1.0),
}


def device_spec(device=None) -> DeviceSpec:
    """The spec of ``device`` (default: the CUDA device if there is one,
    else the CPU). A CUDA card the table lacks raises: its peaks are
    unknown, and another card's would give wrong bounds."""
    if isinstance(device, DeviceSpec):
        return device
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cpu":
        return _DEVICE_TABLE["cpu"]
    name = torch.cuda.get_device_name(device)
    for key, spec in _DEVICE_TABLE.items():
        if key in name.lower():
            return spec
    raise ValueError(f"no published rates for {name!r}; the table has {sorted(_DEVICE_TABLE)}")


# ------------------------------------------------------------------- timing


def measure(fn: Callable[[], object], *, iters: int = 50, warmup: int = 3) -> float:
    """Mean seconds of device time per call of ``fn()`` on the current CUDA
    device: CUDA events around ``iters`` calls after ``warmup`` calls. The
    device first spins for ~50 ms while the host queues every call. There
    is no CPU path."""
    if not torch.cuda.is_available():
        raise RuntimeError("profiling.measure times the CUDA device; there is none")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters / 1e3


# ----------------------------------------------------------------- roofline


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops: int
    bytes: int
    t_compute_s: float   # operations over the peak
    t_memory_s: float    # bytes over the memory rate
    t_roofline_s: float  # the larger: the least time the device could take

    def pct(self, measured_s: float) -> float:
        """Percent of the roofline a measured time reaches."""
        return 100.0 * self.t_roofline_s / max(measured_s, 1e-12)


def matmul_roofline(m: int, k: int, n: int, *, weight_bits: int = 16, block_size: int = 0,
                    act_bytes: int = 2, out_bytes: int = 2, scale_bytes: int = 4,
                    device=None) -> Roofline:
    """Roofline of ``(m, k) @ (k, n)`` with a ``weight_bits`` weight: bytes =
    activations in + the packed weight (+ its block scales) + the output;
    operations = 2mkn at the bf16 tensor-core peak. A bound, not a
    prediction: a quantized weight's dequantization counts as hidden
    behind its fetch."""
    spec = device_spec(device)
    w_bytes = k * n * weight_bits // 8
    s_bytes = (k // block_size) * n * scale_bytes if block_size else 0
    total_bytes = m * k * act_bytes + w_bytes + s_bytes + m * n * out_bytes
    flops = 2 * m * k * n
    t_compute = flops / (spec.bf16_tflops * 1e12)
    t_memory = total_bytes / (spec.hbm_gbps * 1e9)
    return Roofline(flops, total_bytes, t_compute, t_memory, max(t_compute, t_memory))


def decode_step_roofline(cfg, batch: int = 8, weight_bits: int = 16, block_size: int = 0,
                         kv_len: int = 512, kv_bytes: int = 2, device=None) -> Roofline:
    """One Llama decode step's roofline: every projection, the head and
    the KV cache read."""
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    shapes = [(cfg.dim, nh * hd), (cfg.dim, nkv * hd), (cfg.dim, nkv * hd), (nh * hd, cfg.dim),
              (cfg.dim, cfg.hidden_dim), (cfg.dim, cfg.hidden_dim), (cfg.hidden_dim, cfg.dim)]
    flops = bytes_ = 0
    for k, n in shapes:
        r = matmul_roofline(batch, k, n, weight_bits=weight_bits, block_size=block_size,
                            device=device)
        flops += r.flops * cfg.n_layers
        bytes_ += r.bytes * cfg.n_layers
    head = matmul_roofline(batch, cfg.dim, cfg.vocab_size, weight_bits=weight_bits,
                           block_size=block_size, device=device)
    flops += head.flops
    bytes_ += head.bytes
    bytes_ += cfg.n_layers * 2 * batch * kv_len * nkv * hd * kv_bytes  # K and V read
    flops += cfg.n_layers * 2 * 2 * batch * nh * kv_len * hd
    spec = device_spec(device)
    t_compute = flops / (spec.bf16_tflops * 1e12)
    t_memory = bytes_ / (spec.hbm_gbps * 1e9)
    return Roofline(flops, bytes_, t_compute, t_memory, max(t_compute, t_memory))


# -------------------------------------------------------------------- trace


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (the CPU, and the CUDA device when
    there is one); yields the profiler, whose ``key_averages()`` sums time
    by op and kernel, and writes its chrome trace to
    ``logdir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
