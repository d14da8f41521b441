"""What a run may load, and what a run does without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from perfbench import harness

ROOT = harness.ROOT


def test_forbidden_by_top_level_name():
    assert harness.forbidden_modules(["jax", "numpy"]) == ["jax"]
    assert harness.forbidden_modules(["guava_renderer_tpu.ops.gsplat"]) == \
        ["guava_renderer_tpu.ops.gsplat"]
    assert harness.forbidden_modules(["jaxlib.xla_client", "flax.linen"]) == \
        ["flax.linen", "jaxlib.xla_client"]
    assert harness.forbidden_modules(["guava_renderer_tpu_torch", "guava_renderer_tpu_torch.ops",
                                      "jaxtyping", "perfbench.reference"]) == []


def _loaded_by(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; "
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return {m.partition(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_reference_loads_no_port_module():
    top = _loaded_by("import perfbench.reference.frame, perfbench.reference.raster")
    assert "guava_renderer_tpu_torch" not in top
    assert not top & set(harness.FORBIDDEN)


def test_driver_loads_no_jax():
    # the motion driver's imports, as a run makes them
    top = _loaded_by("import perfbench.drivers  # noqa\n"
                     "from perfbench import harness\n"
                     "harness.find_cell('out2048.motion').driver()\n"
                     "import guava_renderer_tpu_torch.cli.context, "
                     "guava_renderer_tpu_torch.cli.inference")
    assert not top & set(harness.FORBIDDEN)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "out2048.motion",
                          "--seed", str(2 ** 34 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and out.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    """A directory with the manifest and the benchmark's files alone: the run
    fails before it prints anything."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; sys.path.insert(0, '.'); from perfbench import run; "
            "run.run_cell('out2048.motion', 1, 1.0, False, torch.device('cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "guava_renderer_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""
