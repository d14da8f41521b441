"""The port's bench script, `bench_torch.py`, driven small on the CPU as
the JAX `bench.py` is in the verify drive: exactly one JSON line on stdout
with the keys a benchmark reads; a failure exits non-zero with no metric
line. The CPU has no device time, so the device fields are null."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--size", "64", "--uv", "32", "--frames", "2", "--repeats", "1",
         "--body-side", "21", "--skip-infer"]
KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_frame_host", "ms_per_frame_device",
        "idle_share", "kernels_per_frame", "raster_settings", "matches_train_config",
        "train_config_raster", "ignored", "device"}


def _run(*args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, str(ROOT / "bench_torch.py"), *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout, env=env)


def test_small_drive_prints_one_json_line():
    p = _run(*SMALL, "--chunk", "8", "--no-tile-cull")
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.splitlines()
    assert len(lines) == 1, p.stdout
    rec = json.loads(lines[0])
    assert KEYS <= rec.keys() and "infer_ms" not in rec and "mfu" not in rec
    assert rec["unit"] == "fps" and rec["value"] > 0
    assert rec["vs_baseline"] == rec["value"] / 60.0
    host = rec["ms_per_frame_host"]
    assert host["best"] <= host["median"] and rec["value"] == 1e3 / host["best"]
    assert rec["ms_per_frame_device"] is None and rec["idle_share"] is None
    assert rec["kernels_per_frame"] is None
    assert rec["device"] == {"kind": "cpu", "smi": None}
    assert rec["ignored"] == {"--chunk": 8, "--tile-cull": False}
    # the defaults are the training config's raster block
    assert rec["matches_train_config"] is True
    assert rec["raster_settings"]["tile"] == rec["train_config_raster"]["tile"] == 32
    assert rec["raster_settings"]["size_classes"] == rec["train_config_raster"]["size_classes"]
    assert "[bench_torch]" in p.stderr


def test_a_failure_exits_nonzero_without_a_metric_line():
    """Settings the JAX package refuses, found before any scene is built.
    (Without a card the default device raises: tests/test_torch_package.py.)"""
    p = _run(*SMALL, "--bf16-rows", "--streaming")
    assert p.returncode != 0 and p.stdout == "" and "bf16_rows" in p.stderr
