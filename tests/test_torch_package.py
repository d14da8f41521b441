"""Package rules of the port: no JAX at all, and CUDA unless asked otherwise."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "guava_renderer_tpu")
PORT_FILES = sorted((ROOT / "guava_renderer_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path.name} imports {bad}"


TRAIN_MODULES = ("train/lpips.py", "train/losses.py", "train/pipeline.py", "train/trainstep.py",
                 "train/checkpoints.py", "cli/trainer_loop.py", "ops/ssim.py",
                 "ops/gsplat_reference.py", "testing.py")


@pytest.mark.parametrize("rel", TRAIN_MODULES)
def test_training_modules_are_in_the_walk(rel):
    assert ROOT / "guava_renderer_tpu_torch" / rel in PORT_FILES


def _entry_points():
    from guava_renderer_tpu_torch import testing
    from guava_renderer_tpu_torch.benchscene import (
        make_bench_scene, make_create_scene, make_train_scene)
    from guava_renderer_tpu_torch.bodymodel.ehm import EhmModel
    from guava_renderer_tpu_torch.cli.inference import FramePipeline
    from guava_renderer_tpu_torch.convert import (
        avatar_from_numpy, inferer_from_flax, lpips_from_flax)
    from guava_renderer_tpu_torch.tools import (
        dma_bench, ee_probe, mosaic_probe, sort_payload_bench)

    return {
        "make_bench_scene": lambda: make_bench_scene(64, 64, 21, 7),
        "make_create_scene": lambda: make_create_scene(32, 16, 12, 6, feat_size=28),
        "FramePipeline": lambda: FramePipeline(None, None, None),
        "FramePipeline with an inferer": lambda: FramePipeline(
            None, None, None, inferer=torch.nn.Identity(), uv_tables=(None, None, None)),
        "EhmModel.build": lambda: EhmModel.build(None, None, None),
        "avatar_from_numpy": lambda: avatar_from_numpy(None),
        "inferer_from_flax": lambda: inferer_from_flax({}, None, 0),
        "make_train_scene": lambda: make_train_scene(32, 16, 12, 6, feat_size=28),
        "make_micro_pipeline": lambda: testing.make_micro_pipeline(batch_size=1),
        "make_tiny_pipeline": lambda: testing.make_tiny_pipeline(batch_size=1),
        "lpips_from_flax": lambda: lpips_from_flax({}),
        "tools.ee_probe": lambda: ee_probe.main([]),
        "tools.dma_bench": lambda: dma_bench.main([]),
        "tools.sort_payload_bench": lambda: sort_payload_bench.main([]),
        "tools.mosaic_probe": lambda: mosaic_probe.main([]),
    }


@pytest.mark.parametrize("name", ["make_bench_scene", "make_create_scene", "FramePipeline",
                                  "FramePipeline with an inferer", "EhmModel.build",
                                  "avatar_from_numpy", "inferer_from_flax", "make_train_scene",
                                  "make_micro_pipeline", "make_tiny_pipeline",
                                  "lpips_from_flax", "tools.ee_probe", "tools.dma_bench",
                                  "tools.sort_payload_bench", "tools.mosaic_probe"])
def test_entry_points_default_to_cuda(name, monkeypatch):
    """Without device=, an entry point asks for CUDA and raises when there
    is none, instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
