"""Package rules of the port: no JAX at all, and CUDA unless asked otherwise."""

import ast
import os
import tempfile
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "guava_renderer_tpu")
# absent on the card: the port reads configs with its own reader, converted
# weights with torch.load, and images with its own codec (data/codec.py)
ABSENT_ON_CARD = ("yaml", "msgpack", "cv2", "PIL", "imageio", "lmdb", "chumpy")
PORT_FILES = sorted((ROOT / "guava_renderer_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]


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


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_absent_on_the_card(path):
    bad = [m for m in _imported_modules(path)
           if any(m == f or m.startswith(f + ".") for f in ABSENT_ON_CARD)]
    assert not bad, f"{path.name} imports {bad}"


TRAIN_MODULES = ("train/lpips.py", "train/losses.py", "train/pipeline.py", "train/trainstep.py",
                 "train/checkpoints.py", "cli/trainer_loop.py", "ops/ssim.py",
                 "ops/gsplat_reference.py", "testing.py", "data/__init__.py", "data/store.py",
                 "data/codec.py", "data/tracked.py", "data/loader.py", "data/synthetic.py",
                 "native/__init__.py", "utils/logging_utils.py", "train/metrics.py",
                 "cli/train.py", "tools/make_teacher_dataset.py")


@pytest.mark.parametrize("rel", TRAIN_MODULES)
def test_training_modules_are_in_the_walk(rel):
    assert ROOT / "guava_renderer_tpu_torch" / rel in PORT_FILES


DRIVER_MODULES = ("motion.py", "utils/camera_orbit.py", "utils/video.py", "avatar/deformer.py",
                  "train/checkpoints.py", "cli/inference.py", "cli/test.py",
                  "cli/create_avatar.py", "cli/render_motion.py", "cli/convert_motion.py",
                  "cli/resample_motion.py", "cli/metrics.py", "cli/metrics_face.py",
                  "cli/app.py")


@pytest.mark.parametrize("rel", DRIVER_MODULES)
def test_driver_modules_are_in_the_walk(rel):
    assert ROOT / "guava_renderer_tpu_torch" / rel in PORT_FILES


BODYMODEL_MODULES = ("core/rotations.py", "core/cameras.py", "core/lbs.py", "core/mesh.py",
                     "bodymodel/__init__.py", "bodymodel/data.py", "bodymodel/flame_regions.py",
                     "bodymodel/smplx.py", "bodymodel/flame.py", "bodymodel/flame_mask.py",
                     "bodymodel/landmarks.py", "bodymodel/ehm.py", "cli/context.py",
                     "testing.py")


@pytest.mark.parametrize("rel", BODYMODEL_MODULES)
def test_body_model_modules_are_in_the_walk(rel):
    assert ROOT / "guava_renderer_tpu_torch" / rel in PORT_FILES


MULTI_DEVICE_MODULES = ("parallel/__init__.py", "parallel/mesh.py", "parallel/batch_render.py",
                        "parallel/sharded_render.py", "ops/knn.py", "train/trainstep.py",
                        "cli/trainer_loop.py", "cli/train.py", "cli/test.py", "cli/inference.py")


@pytest.mark.parametrize("rel", MULTI_DEVICE_MODULES)
def test_multi_device_modules_are_in_the_walk(rel):
    assert ROOT / "guava_renderer_tpu_torch" / rel in PORT_FILES


def _build_runtime_on_real_files(micro):
    """build_runtime on micro_synthetic.yaml pointed at reduced-count schema files."""
    from guava_renderer_tpu_torch.cli.context import build_runtime
    from guava_renderer_tpu_torch.testing import write_schema_assets
    from guava_renderer_tpu_torch.utils.config import load_config

    with tempfile.TemporaryDirectory() as d:
        paths = write_schema_assets(d, seed=0,
                                    counts={"smplx_vertices": 6223, "smplx_faces": 12376})
        return build_runtime(load_config(micro, {"MODEL": {
            "smplx_assets_dir": paths["smplx_dir"], "flame_assets_dir": paths["flame_dir"]}}))


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
    from guava_renderer_tpu_torch.cli.context import build_runtime
    from guava_renderer_tpu_torch.core.cameras import look_at_camera
    from guava_renderer_tpu_torch.bodymodel.landmarks import landmark_tables_from_smplx_npz
    from guava_renderer_tpu_torch.utils.config import load_config
    from guava_renderer_tpu_torch.cli import train as cli_train
    from guava_renderer_tpu_torch.cli.trainer_loop import run_training
    from guava_renderer_tpu_torch.tools import make_teacher_dataset
    from guava_renderer_tpu_torch.cli import app, create_avatar, metrics, render_motion
    from guava_renderer_tpu_torch.cli import test as cli_test
    from guava_renderer_tpu_torch.cli.inference import render_set
    from guava_renderer_tpu_torch.parallel.mesh import launch
    import bench_torch

    micro = str(ROOT / "configs" / "train" / "micro_synthetic.yaml")
    scratch = tempfile.mkdtemp()

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
        "build_runtime": lambda: build_runtime(load_config(micro), synthetic_assets=True),
        "build_runtime on real files": lambda: _build_runtime_on_real_files(micro),
        "look_at_camera": lambda: look_at_camera((0.0, 0.0, -3.0), (0.0, 0.0, 0.0)),
        "landmark_tables_from_smplx_npz": lambda: landmark_tables_from_smplx_npz({}),
        "bench_torch": lambda: bench_torch.main([]),
        "cli.train": lambda: cli_train.main(["-c", micro, "--synthetic_assets"]),
        "tools.make_teacher_dataset": lambda: make_teacher_dataset.main(
            ["--out", os.path.join(scratch, "teacher"), "-c", micro]),
        "run_training": lambda: run_training(
            build_runtime(load_config(micro), synthetic_assets=True), None, None, scratch),
        "cli.test": lambda: cli_test.main(["-c", micro, "--data_path", scratch,
                                           "--synthetic_assets"]),
        "cli.create_avatar": lambda: create_avatar.main(["-m", micro, "--data_path", scratch,
                                                         "--synthetic_assets"]),
        "cli.render_motion": lambda: render_motion.main(["-a", scratch, "-m", micro,
                                                         "--synthetic_assets"]),
        "cli.metrics": lambda: metrics.main(["-m", scratch]),
        "cli.app": lambda: app.GenerationService(types.SimpleNamespace(model_path=micro)),
        "render_set": lambda: render_set(
            build_runtime(load_config(micro), synthetic_assets=True), None, None, scratch),
        "parallel.launch": lambda: launch(2, print),
        "cli.train --devices 2": lambda: cli_train.main(["-c", micro, "--synthetic_assets",
                                                         "--devices", "2"]),
        "cli.test --dp_render -d 2": lambda: cli_test.main(
            ["-c", micro, "--data_path", scratch, "--synthetic_assets", "--dp_render",
             "-d", "2"]),
        "cli.train --devices 0,1": lambda: cli_train.main(["-c", micro, "--synthetic_assets",
                                                           "--devices", "0,1"]),
        "cli.test --dp_render -d 0,1": lambda: cli_test.main(
            ["-c", micro, "--data_path", scratch, "--synthetic_assets", "--dp_render",
             "-d", "0,1"]),
    }


@pytest.mark.parametrize("name", ["make_bench_scene", "make_create_scene", "FramePipeline",
                                  "FramePipeline with an inferer", "EhmModel.build",
                                  "avatar_from_numpy", "inferer_from_flax", "make_train_scene",
                                  "make_micro_pipeline", "make_tiny_pipeline",
                                  "lpips_from_flax", "tools.ee_probe", "tools.dma_bench",
                                  "tools.sort_payload_bench", "tools.mosaic_probe",
                                  "build_runtime", "build_runtime on real files",
                                  "look_at_camera", "landmark_tables_from_smplx_npz",
                                  "bench_torch", "cli.train",
                                  "tools.make_teacher_dataset", "run_training", "cli.test",
                                  "cli.create_avatar", "cli.render_motion", "cli.metrics",
                                  "cli.app", "render_set", "parallel.launch",
                                  "cli.train --devices 2", "cli.test --dp_render -d 2",
                                  "cli.train --devices 0,1", "cli.test --dp_render -d 0,1"])
def test_entry_points_default_to_cuda(name, monkeypatch):
    """Without device=, an entry point asks for CUDA and raises when there
    is none, instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_cuda_entry_device_turns_tf32_off(monkeypatch):
    """An entry point's CUDA device computes float32 convolutions and matrix
    products in float32, the precision the port is held to; the CPU device
    leaves the flags as they are."""
    from guava_renderer_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert resolve_device().type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
