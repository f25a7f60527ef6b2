"""Benchmarks of the port; each runs with ``python -m`` on a CUDA
device:

  python -m quanta_tpu_torch.benchmarks.decode_bench   # decode/prefill/TTFT
  python -m quanta_tpu_torch.benchmarks.serve_bench    # the Engine under Poisson load
  python -m quanta_tpu_torch.benchmarks.train_bench    # QLoRA steps
  python -m quanta_tpu_torch.benchmarks.accuracy_bench # perplexity delta per format
"""
