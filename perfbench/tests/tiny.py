"""A cell of the manifest cut to a size the CPU runs in seconds, for the
harness's tests."""

from __future__ import annotations

import copy

from perfbench import harness


def tiny_cell(name: str = "out2048.motion", size: int = 64, refiner: int = 32,
              frames: int = 6) -> harness.Cell:
    cell = harness.find_cell(name)
    cell = copy.deepcopy(cell)
    m = cell.config["config"]["MODEL"]
    m.update(image_size=size, uvmap_size=32, synthetic_body_side=21, synthetic_head_side=6,
             synthetic_n_shape=8, synthetic_n_exp=4)
    m["styleunet"].update(in_size=refiner, out_size=refiner)
    m["raster"]["tile"] = 16
    cell.traffic.update(frames=frames, warmup_frames=2)
    cell.workload["check"].update(frames=1, within=1)
    return cell


def tiny_train_cell() -> harness.Cell:
    """`ubody512.train` at the widths of configs/train/micro_synthetic.yaml
    (batch 2, 32x32 images, a 16x16 chart), on a store of one 8-frame video."""
    from guava_renderer_tpu_torch.utils.config import load_config

    cell = copy.deepcopy(harness.find_cell("ubody512.train"))
    micro = load_config(str(harness.ROOT / "configs" / "train" / "micro_synthetic.yaml"))
    cfg = cell.config["config"]
    cfg["MODEL"] = micro.MODEL.to_dict()
    cfg["TRAIN"]["batch_size"] = 2
    cfg["OPTIMIZE"]["crop_size"] = 16
    cfg["DATASET"].update(origin_image_size=48, head_crop_size=24, hand_crop_size=24)
    cell.config["assumed"]["restore_every"] = 2
    cell.traffic.update(videos=1, frames_per_video=8, image_size=48, n_shape=8, n_exp=4)
    return cell
