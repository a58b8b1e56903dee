"""The benchmark of cylon_tpu_torch: one cell a run, to ``BENCHMARK.json``."""
