"""The benchmark of `guava_renderer_tpu_torch` (see `BENCHMARK.json` and `PERF.md`)."""
