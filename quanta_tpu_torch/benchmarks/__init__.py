"""Benchmarks of the port; each runs with ``python -m`` on a CUDA
device:

  python -m quanta_tpu_torch.benchmarks.decode_bench   # decode/prefill/TTFT
"""
