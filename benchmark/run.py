#!/usr/bin/env python3
"""Run one cell of the benchmark of ``nndetection_tpu_torch`` on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (see ``README.md``). The caches of the program's kernels stay inside
the checkout: the Triton cache under ``benchmark/.cache/``, the nvcc
library under ``nndetection_tpu_torch/_build/``.
"""
import os
import sys
import time

T_START = time.perf_counter()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT_DIR = os.path.dirname(BENCH_DIR)


def _environment() -> None:
    """Fixed cache directories inside the checkout, set before torch or
    triton load; the program's switches left to the configuration."""
    cache = os.path.join(BENCH_DIR, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for name in ("NNDET_CONV_FUSED", "NNDET_POOL_BYTES", "NNDET_IN_STATS"):
        os.environ.pop(name, None)


if __name__ == "__main__":
    _environment()
    if sys.path and os.path.abspath(sys.path[0]) == BENCH_DIR:
        sys.path.pop(0)
    sys.path.insert(0, ROOT_DIR)
    from benchmark.harness import run

    sys.exit(run(sys.argv[1:], t_start=T_START))
