#!/usr/bin/env python
"""Benchmark entry point (prints ONE JSON line
{"metric", "value", "unit", "vs_baseline", ..., "device": {...}}; needs
a GPU).

The implementation lives in scs_tpu/bench_cli.py (also installed as the
`scs-tpu-bench` console script). Env knobs: BENCH_BATCH (default 512),
BENCH_M/BENCH_N (1500/1000), BENCH_EPS (1e-4), BENCH_DTYPE (float32),
BENCH_CHUNKS (auto); BENCH_BELL=1 switches to the sparse block-ELL
workload. Baseline derivation is documented in scs_tpu/bench_cli.py and
emitted in the JSON itself.
"""

from scs_tpu.bench_cli import main

if __name__ == "__main__":
    main()
