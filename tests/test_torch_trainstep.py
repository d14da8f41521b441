"""The port's train step on toy models (the cases of tests/test_trainstep.py)
and its optimizer against optax on given gradients.

The optimizer comparison feeds both sides the same gradients for three
steps, so it holds the update rule alone: Adam (0, 0.99), eps 1e-8, the 0.1x
group, the linear decay. atol 1e-7 on parameters of order 1 moved by 1e-2.
"""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from guava_renderer_tpu.train.trainstep import make_optimizer as jmake_optimizer
from guava_renderer_tpu_torch.train.trainstep import (
    TrainState, batch_size, lr_labels, make_optimizer, make_sample_scan_step, make_train_state,
    make_train_step, scrub_nan_grads, split_batch)

torch.set_num_threads(2)


class Toy(nn.Module):
    """dense -> refiner.generator.style_mlp.mlp0 -> final_linear, all ones."""

    def __init__(self, n=4):
        super().__init__()
        self.dense = nn.Linear(n, n)
        self.refiner = nn.ModuleDict({"generator": nn.ModuleDict({"style_mlp": nn.ModuleDict(
            {"mlp0": nn.Linear(n, n, bias=False)})})})
        self.final_linear = nn.Linear(n, n, bias=False)
        with torch.no_grad():
            for p in self.parameters():
                p.fill_(1.0)
            self.dense.bias.zero_()

    def forward(self, x):
        return self.final_linear(self.refiner["generator"]["style_mlp"]["mlp0"](self.dense(x)))


def toy_loss_fn(model):
    def loss_fn(batch, iteration):
        loss = ((model(batch["x"]) - batch["y"]) ** 2).mean()
        return loss, {"loss": loss}
    return loss_fn


def make_batch(n=8):
    rng = np.random.default_rng(0)
    return {"x": torch.tensor(rng.normal(size=(n, 4)).astype(np.float32)),
            "y": torch.tensor(rng.normal(size=(n, 4)).astype(np.float32))}


def test_lr_labels():
    labels = lr_labels(Toy())
    assert labels == {"dense.weight": "normal", "dense.bias": "normal",
                      "refiner.generator.style_mlp.mlp0.weight": "slow",
                      "final_linear.weight": "slow"}


def test_lr_groups_move_at_different_rates():
    model = Toy()
    state = make_train_state(model, learning_rate=1e-2)
    loss, metrics = make_train_step(toy_loss_fn(model), state)(make_batch())
    assert state.iteration == 1 and float(loss) == float(metrics["loss"])
    d_normal = float((model.dense.weight - 1.0).abs().max())
    d_slow_a = float((model.refiner["generator"]["style_mlp"]["mlp0"].weight - 1.0).abs().max())
    d_slow_b = float((model.final_linear.weight - 1.0).abs().max())
    assert d_normal > 0
    np.testing.assert_allclose(d_slow_a / d_normal, 0.1, rtol=0.05)
    np.testing.assert_allclose(d_slow_b / d_normal, 0.1, rtol=0.05)


def test_nan_grads_scrubbed():
    model = Toy(2)

    def bad_loss(batch, iteration):
        b = model.dense.bias
        # sqrt at 0 under a where: a NaN gradient for the bias, a finite loss
        loss = model.dense.weight.sum() + torch.where(b == 0, 0.0, torch.sqrt(b)).sum() \
            + 0.0 * model.final_linear.weight.sum()
        return loss, {}

    state = make_train_state(model, learning_rate=1e-2)
    loss, metrics = make_train_step(bad_loss, state, count_scrubbed=True)(None)
    assert np.isfinite(float(loss))
    assert int(metrics["scrubbed_grads"]) == 2
    for n, p in model.named_parameters():
        assert bool(torch.isfinite(p).all()), n
    assert float((model.dense.bias).abs().max()) == 0.0       # a scrubbed gradient moves nothing
    assert float((model.dense.weight - 1.0).abs().max()) > 0


def test_scrub_counts_and_zeroes():
    model = nn.Linear(3, 2)
    model.weight.grad = torch.tensor([[1.0, float("nan"), 2.0], [float("inf"), 0.0, -float("inf")]])
    assert model.bias.grad is None
    assert int(scrub_nan_grads(model, count=True)) == 3
    assert model.weight.grad.tolist() == [[1.0, 0.0, 2.0], [0.0, 0.0, 0.0]]
    assert scrub_nan_grads(model) is None


def test_lr_schedule_decays():
    model = Toy()
    state = make_train_state(model, learning_rate=1e-2, lr_decay_rate=0.5, lr_decay_iter=10)
    step = make_train_step(toy_loss_fn(model), state)
    batch = make_batch()
    deltas, prev = [], model.dense.weight.detach().clone()
    lrs = []
    for _ in range(12):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        step(batch)
        cur = model.dense.weight.detach().clone()
        deltas.append(float((cur - prev).abs().mean()))
        prev = cur
    assert deltas[-1] < deltas[0] * 0.8
    np.testing.assert_allclose(lrs[0], 1e-2)
    np.testing.assert_allclose(lrs[5], 1e-2 * 0.75)
    np.testing.assert_allclose(lrs[10:], [5e-3, 5e-3])          # held after the decay
    assert state.optimizer.param_groups[1]["lr"] == pytest.approx(0.1 * 5e-3)


def test_sample_scan_step_matches_batched():
    batch = make_batch(4)
    results = []
    for make in (make_train_step, make_sample_scan_step):
        model = Toy()
        state = make_train_state(model, learning_rate=1e-2)
        loss, metrics = make(toy_loss_fn(model), state)(batch)
        results.append((float(loss), float(metrics["loss"]),
                        [p.detach().clone() for p in model.parameters()]))
    (lb, mb, pb), (ls, ms, ps) = results
    np.testing.assert_allclose(lb, ls, rtol=1e-5)
    np.testing.assert_allclose(mb, ms, rtol=1e-5)
    for a, b in zip(pb, ps):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_split_batch():
    batch = {"a": torch.arange(6).reshape(3, 2), "n": {"b": torch.arange(3.0)}, "k": 5}
    assert batch_size(batch) == 3
    one = split_batch(batch, 1)
    assert one["a"].tolist() == [[2, 3]] and one["n"]["b"].tolist() == [1.0] and one["k"] == 5


@pytest.mark.parametrize("decay", [(0.03, 200000), (0.5, 2)])
def test_optimizer_vs_optax_on_given_gradients(decay):
    rate, iters = decay
    rng = np.random.default_rng(4)
    model = Toy()
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.tensor(rng.normal(size=tuple(p.shape)).astype(np.float32)))

    def to_tree(values):     # parameter name -> the nested tree optax labels by path
        v = dict(zip(names, values))
        return {"dense": {"kernel": v["dense.weight"], "bias": v["dense.bias"]},
                "refiner": {"generator": {"style_mlp": {"mlp0": {
                    "kernel": v["refiner.generator.style_mlp.mlp0.weight"]}}}},
                "final_linear": {"kernel": v["final_linear.weight"]}}

    jparams = to_tree([jnp.asarray(p.detach().numpy()) for p in model.parameters()])
    opt = jmake_optimizer(jparams, learning_rate=1e-2, lr_decay_rate=rate, lr_decay_iter=iters)
    opt_state = opt.init(jparams)
    optimizer, scheduler = make_optimizer(model, learning_rate=1e-2, lr_decay_rate=rate,
                                          lr_decay_iter=iters)
    for step in range(3):
        grads = [(rng.normal(size=tuple(p.shape)) * 10.0 ** rng.integers(-6, 2)).astype(np.float32)
                 for p in model.parameters()]
        grads[1][0] = np.nan if step == 1 else grads[1][0]        # scrubbed on both sides
        updates, opt_state = opt.update(to_tree([jnp.asarray(g) for g in grads]), opt_state,
                                        jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(model.parameters(), grads):
            p.grad = torch.tensor(g)
        scrub_nan_grads(model)
        optimizer.step()
        scheduler.step()
        got = to_tree([p.detach().numpy() for p in model.parameters()])
        for a, b in zip(_leaves(got), _leaves(jparams)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-7, rtol=0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def test_train_state_round_trip():
    model = Toy()
    state = make_train_state(model, learning_rate=1e-2, lr_decay_rate=0.5, lr_decay_iter=10)
    step = make_train_step(toy_loss_fn(model), state)
    for _ in range(3):
        step(make_batch())
    saved = copy.deepcopy(state.state_dict())    # state_dict() hands out the live tensors
    other = Toy()
    restored = make_train_state(other, learning_rate=1e-2, lr_decay_rate=0.5, lr_decay_iter=10)
    restored.load_state_dict(saved)
    assert isinstance(restored, TrainState) and restored.iteration == 3
    # both take the same fourth step
    step(make_batch())
    make_train_step(toy_loss_fn(other), restored)(make_batch())
    for a, b in zip(model.parameters(), other.parameters()):
        assert torch.equal(a, b)
    assert restored.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]


def test_restore_keeps_the_states_own_hyperparameters():
    """A state restored from a file saved at another learning rate takes the
    file's weights, moments and schedule position, and keeps its own rate and
    schedule: lr = its base rate x its decay factor at the saved position."""
    model = Toy()
    state = make_train_state(model, learning_rate=1e-2, lr_decay_rate=0.5, lr_decay_iter=10)
    step = make_train_step(toy_loss_fn(model), state)
    for _ in range(3):
        step(make_batch())
    saved = copy.deepcopy(state.state_dict())
    other = Toy()
    restored = make_train_state(other, learning_rate=1e-3, lr_decay_rate=0.5, lr_decay_iter=10)
    restored.load_state_dict(saved)
    factor = 1.0 + (0.5 - 1.0) * 3 / 10
    assert restored.iteration == 3 and restored.scheduler.last_epoch == 3
    assert restored.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3 * factor, rel=1e-12)
    assert restored.scheduler.get_last_lr()[0] == restored.optimizer.param_groups[0]["lr"]
    for a, b in zip(model.parameters(), other.parameters()):
        assert torch.equal(a, b)
    for p in model.parameters():
        assert torch.equal(state.optimizer.state[p]["exp_avg_sq"],
                           restored.optimizer.state[dict(zip(model.parameters(),
                                                             other.parameters()))[p]]["exp_avg_sq"])
    make_train_step(toy_loss_fn(other), restored)(make_batch())
    assert restored.scheduler.last_epoch == 4
