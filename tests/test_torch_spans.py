"""The port's spans and counters (`utils/logging_utils.py`).

With no profiler a span records nothing and a count leaves the counters
empty. Under torch.profiler on the CPU, a micro frame and a micro training
step record each layer's span inside `guava.render_frame` and
`guava.train_step`, on the thread that runs them, the `instances`
counter holds what binning binned, and `resize.table_uploads` the
resizes' table-cache misses (the first frame's, none on the second).
"""

from pathlib import Path

import pytest
import torch

from guava_renderer_tpu_torch.cli import context as tctx
from guava_renderer_tpu_torch.cli.inference import FramePipeline
from guava_renderer_tpu_torch.data.loader import DeviceBatches, PrefetchLoader, endless
from guava_renderer_tpu_torch.data.synthetic import write_synthetic_dataset
from guava_renderer_tpu_torch.data.tracked import build_dataset
from guava_renderer_tpu_torch.models import layers as tlayers
from guava_renderer_tpu_torch.ops import gsplat
from guava_renderer_tpu_torch.train.pipeline import make_loss_fn
from guava_renderer_tpu_torch.train.trainstep import make_train_state, make_train_step
from guava_renderer_tpu_torch.utils import logging_utils as lu
from guava_renderer_tpu_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parents[1]
MICRO = str(ROOT / "configs" / "train" / "micro_synthetic.yaml")

FRAME_SPANS = ("guava.deform", "guava.bin", "guava.blend", "guava.resize", "guava.refine",
               "guava.sync.params", "guava.sync.lbs", "guava.sync.camera", "guava.sync.bin",
               "guava.sync.resize_weights")
STEP_SPANS = ("guava.create", "guava.deform", "guava.bin", "guava.blend", "guava.resize",
              "guava.refine", "guava.loss", "guava.backward", "guava.update", "guava.sync.lbs",
              "guava.sync.camera", "guava.sync.mesh_bin", "guava.sync.bin",
              "guava.sync.resize_weights")


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """The micro runtime (seeded weights) with its refiner at 16 between two
    resizes of the 32x32 raster, and its two-item dataset."""
    data = str(tmp_path_factory.mktemp("spans") / "ds")
    write_synthetic_dataset(data, n_videos=1, n_frames=4, image_size=48, n_shape=8, n_exp=4)
    cfg = load_config(MICRO, {"DATASET": {"data_path": data},
                              "MODEL": {"styleunet": {"in_size": 16, "out_size": 16}}})
    return tctx.init_params(tctx.build_runtime(cfg, synthetic_assets=True, device="cpu")), cfg


@pytest.fixture
def binned(monkeypatch):
    """The instance count of every `bin_gaussians` call."""
    seen = []
    bin_gaussians = gsplat.bin_gaussians

    def counting(*args, **kwargs):
        ranges, order = bin_gaussians(*args, **kwargs)
        seen.append(int(order.shape[0]))
        return ranges, order

    monkeypatch.setattr(gsplat, "bin_gaussians", counting)
    return seen


def profiled(fn):
    """-> (fn's result, [(name, start, end, thread)] of the trace's host events)."""
    lu.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()]
    return out, events


def assert_nested(events, outer: str, inner: tuple):
    (o,) = [e for e in events if e[0] == outer]
    for name in inner:
        found = [e for e in events if e[0] == name]
        assert found, f"no {name} span"
        for _, start, end, thread in found:
            assert thread == o[3] and o[1] <= start and end <= o[2], f"{name} outside {outer}"


def test_off_path_records_nothing():
    lu.reset_counters()
    off = lu.span("guava.test")
    assert off is lu.span("guava.other")      # one shared no-op: nothing made a call
    with off:
        torch.ones(4).sum()
    lu.count("instances", 5)

    @lu.spanned("guava.fn")
    def f(x):
        return x + 1

    assert f(2) == 3
    assert lu.counters() == {} and lu.span_seconds() == {}


def test_on_path_records_and_resets():
    def work():
        with lu.span("guava.outer"):
            with lu.span("guava.inner"):
                torch.ones(4).sum()
        lu.count("instances", 5)
        lu.count("instances", 2)

    _, events = profiled(work)
    assert_nested(events, "guava.outer", ("guava.inner",))
    assert lu.counters() == {"instances": 7}
    seconds = lu.span_seconds()
    assert set(seconds) == {"guava.outer", "guava.inner"}
    assert seconds["guava.outer"] >= seconds["guava.inner"] > 0
    lu.reset_counters()
    assert lu.counters() == {} and lu.span_seconds() == {}


def uploads(counters: dict) -> int:
    """Pop the resizes' table uploads (cache misses) from a counters dict."""
    return counters.pop("resize.table_uploads", 0)


def test_frame_spans_nest_under_render_frame(micro, binned):
    """The resizes' tables are made on the first frame (`guava.sync.resize_weights`,
    `resize.table_uploads`) and reused by the second, which uploads nothing."""
    rt, cfg = micro
    item = build_dataset(cfg, "train")[0]
    pipe = FramePipeline.from_runtime(rt)
    avatar, _ = pipe.infer_avatar(item["source"])
    tlayers._resize_axis.cache_clear()
    binned.clear()
    out, events = profiled(lambda: pipe.render_frame(avatar, item["target"]))
    assert out["render"].shape == (32, 32, 3)
    assert_nested(events, "guava.render_frame", FRAME_SPANS)
    counters = lu.counters()
    assert uploads(counters) == 2                 # 32 -> 16 and 16 -> 32, both axes alike
    assert binned and counters == {"instances": sum(binned)}
    assert lu.span_seconds()["guava.render_frame"] > 0

    binned.clear()
    _, events = profiled(lambda: pipe.render_frame(avatar, item["target"]))
    assert_nested(events, "guava.render_frame",
                  tuple(n for n in FRAME_SPANS if n != "guava.sync.resize_weights"))
    assert "guava.sync.resize_weights" not in {e[0] for e in events}
    assert lu.counters() == {"instances": sum(binned)}


def test_step_spans_nest_under_train_step(micro, binned):
    rt, cfg = micro
    state = make_train_state(rt.model)
    step = make_train_step(make_loss_fn(rt.statics, rt.lpips), state)
    loader = PrefetchLoader(build_dataset(cfg, "train"), 2, seed=0)
    batches = iter(DeviceBatches(endless(loader), torch.device("cpu")))
    tlayers._resize_axis.cache_clear()
    binned.clear()
    (loss, _), events = profiled(lambda: step(next(batches)))
    assert torch.isfinite(loss)
    assert_nested(events, "guava.train_step", STEP_SPANS)
    names = {e[0] for e in events}
    assert {"guava.loader.wait", "guava.loader.to_device"} <= names
    counters = lu.counters()
    assert uploads(counters) > 0
    assert binned and counters == {"instances": sum(binned)}
    assert lu.span_seconds()["guava.loader.wait"] >= 0.0


def test_counts_from_many_threads_add_up():
    """The counters and the spans' seconds are shared by the threads that
    record them (the step's main thread, autograd's): no update is lost."""
    import sys
    import threading

    n_threads, n = 8, 200

    def work():
        for _ in range(n):
            lu.count("instances", 1)
            with lu.span("guava.t"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run_all():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        profiled(run_all)
    finally:
        sys.setswitchinterval(interval)
    assert lu.counters() == {"instances": n_threads * n}
    assert lu.span_seconds()["guava.t"] > 0
