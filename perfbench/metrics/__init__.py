"""Per-layer metric readers: `perfbench/metrics/<metric>.py` for each
per-layer metric of the manifest, each with `read(run) -> float | None`
(None where the run has nothing to read)."""
