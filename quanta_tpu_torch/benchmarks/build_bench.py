"""Wall time of the CUDA kernels' build, two ways, on the same sources and
flags.

``parallel`` is what ``ops/_build.py`` does: one ``nvcc -c`` per source,
all started together, then one link. ``serial`` is one ``nvcc`` over every
source, which compiles them one after another and links. Each runs
``--reps`` times, in the order parallel, serial, serial, parallel, ...,
each into a new temporary directory under ``quanta_tpu_torch/_build/``,
so nothing is reused.

    python -m quanta_tpu_torch.benchmarks.build_bench   # one JSON line

Needs ``nvcc``; it does not use a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import tempfile
import time
from unittest import mock

from quanta_tpu_torch.ops import _build


def build_parallel(out_dir: pathlib.Path) -> None:
    with mock.patch.object(_build, "BUILD_ROOT", out_dir):
        _build._build()


def build_serial(out_dir: pathlib.Path) -> None:
    cus = [str(p) for p in _build._sources() if p.suffix == ".cu"]
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
                    "-o", str(out_dir / "libquanta_kernels.so"), *cus],
                   check=True, capture_output=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    routes = {"parallel": build_parallel, "serial": build_serial}
    order = [("parallel", "serial"), ("serial", "parallel")]
    seconds = {name: [] for name in routes}
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    for i in range(args.reps):
        for name in order[i % 2]:
            with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as d:
                t0 = time.perf_counter()
                routes[name](pathlib.Path(d))
                seconds[name].append(time.perf_counter() - t0)
    print(json.dumps({"sources": [p.name for p in _build._sources()], "cpus": os.cpu_count(),
                      "seconds": seconds}))


if __name__ == "__main__":
    main()
