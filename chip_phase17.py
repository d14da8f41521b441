"""Phase 17 of `chip_smoke.py` (the multi-device paths) alone, on one card.

    python3 chip_phase17.py                 # phase 4's setup at full width, then phase 17
    python3 chip_phase17.py --spread 6 3    # the rerun spread of phase 17 (a)'s real-loss runs

The first form builds the kernels, renders phase 4's frames and runs
`chip_smoke.multi_device` on them, with every check of the whole script.
`--spread S P` runs `make_train_step` S times and `make_parallel_train_step`
(an NCCL world of one) P times, each for `P17_STEPS` steps at phase 8's
widths from one start, and prints every pair's distance (`p17_gap`: the
largest entry over each tensor's largest, and L2) on step 1's gradients
and on the parameters after each step, with the entries more than half
the learning rate apart: the numbers behind `P17_DRIFT_FACTOR`. Run from
the repository root; needs a CUDA device (importing `chip_smoke` exits
without one).
"""

import argparse
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs


def phase17(smi):
    sc = cs.make_bench_scene(cs.SIZE, cs.UV, cs.BODY_SIDE, cs.HEAD_SIDE, device=cs.DEV)
    refiner = cs.init_params_(cs.NeuralRefiner(cs.SIZE, style_dim=512, num_mlp=8,
                                               channel_scale=1.0), torch.Generator().manual_seed(0))
    pipe = cs.FramePipeline(sc.ehm, sc.faces, refiner, image_size=cs.SIZE,
                            invtanfov=cs.INVTANFOV, settings=cs.RasterizeSettings(tile=cs.TILE),
                            opacity_threshold=0.0, device=cs.DEV)
    main_avatar = pipe.prepare_avatar(sc.avatar)
    n_shape, n_exp = sc.smplx.n_shape, sc.smplx.n_exp
    targets = [{"params": {"shape": np.zeros(n_shape, np.float32),
                           "body_pose": np.full((21, 3), 0.01 * i, np.float32),
                           "flame_shape": np.zeros(n_shape, np.float32),
                           "flame_exp": np.zeros(n_exp, np.float32),
                           "flame_jaw": np.zeros(3, np.float32)},
                "w2c": sc.w2c} for i in range(cs.P17_FRAMES)]
    pipe.render_frame(main_avatar, targets[0])       # warm-up
    seq = [pipe.render_frame(main_avatar, t) for t in targets]
    t17, launches = cs.multi_device(smi, pipe, main_avatar, targets, seq, sc)
    cs.say(17, f"phase 17 in {t17:.1f} s on {smi}; its launches {launches}")


def spread(n_single, n_parallel):
    tcfg = cs.InfererConfig(image_size=cs.SIZE, uvmap_size=cs.UV, invtanfov=cs.INVTANFOV)
    tsc = cs.make_train_scene(cs.SIZE, cs.UV, cs.BODY_SIDE, cs.HEAD_SIDE, feat_size=cs.FEAT,
                              batch_size=1, device=cs.DEV)
    _, _, state, loss_fn = cs.train_setup(tsc, tcfg, cs.TRAIN_LR)
    model = state.model
    params = list(model.parameters())
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory(dir=cs.ROOT / "build") as work:
        group = cs.mesh.init_group(0, 1, cs.DEV, f"{work}/rendezvous", cs.P17_BACKEND)
        try:
            def run(make_step):
                model.load_state_dict(start)
                step = make_step(loss_fn, cs.make_train_state(model, learning_rate=cs.TRAIN_LR))
                losses, after = [], []
                for t in range(cs.P17_STEPS):
                    losses.append(float(step(tsc.batch)[0]))
                    if t == 0:
                        grad = [None if p.grad is None else p.grad.detach().clone()
                                for p in params]
                    after.append([p.detach().clone() for p in params])
                return losses, grad, after

            def parallel(loss, st):
                return cs.make_parallel_train_step(loss, st, group)

            runs = ([("single", run(cs.make_train_step)) for _ in range(n_single)]
                    + [("parallel", run(parallel)) for _ in range(n_parallel)])
        finally:
            cs.mesh.close_group()
    for i, (kind, (losses, _, _)) in enumerate(runs):
        print(f"run {i} {kind}: losses {losses}", flush=True)
    for i in range(len(runs)):
        for j in range(i):
            a, b = runs[i][1], runs[j][1]
            line = f"{i} vs {j}: step 1's gradients {cs.p17_gap(a[1], b[1])}"
            for t in range(cs.P17_STEPS):
                apart = sum(int(((x - y).abs() > cs.TRAIN_LR / 2).sum())
                            for x, y in zip(a[2][t], b[2][t]))
                line += (f"; parameters after step {t + 1} {cs.p17_gap(a[2][t], b[2][t])}, "
                         f"{apart} entries over lr/2 apart")
            print(line, flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--spread", nargs=2, type=int, metavar=("SINGLE", "PARALLEL"))
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cs.build.library()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    (cs.ROOT / "build").mkdir(exist_ok=True)
    if args.spread:
        spread(*args.spread)
    else:
        phase17(smi)
    print(f"done in {time.perf_counter() - t0:.1f} s on {smi}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
