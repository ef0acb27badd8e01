"""The port's optimizers and learning-rate schedules against the JAX
package's (`ei_nexus_tpu/train/optim.py`, optax), on the CPU.

Tolerances, each with its reason:
 - schedules: rtol 1e-6 with atol 1e-6 of the base lr (the JAX
   schedules compute in float32 from an int32 step count, the port in
   float64 from a Python int; float32's cosine near its minimum is off by
   ~5e-8 of the base lr);
 - optimizers: parameters after each of 5 updates atol 1e-6 (float32
   moments and bias corrections in another order: a few ulps of
   parameters up to 2.3, ~1e-4 of a step of lr 1e-2);
 - the plateau controller: exact (the same host arithmetic).
"""

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from ei_nexus_tpu.train import optim as jopt
from ei_nexus_tpu_torch.train import optim as topt

SPE = 4          # steps an epoch
EPOCHS = 3

SCHEDULES = {
    "StepLR": {"StepLR": {"step_size": 1, "gamma": 0.5}},
    "MultiStepLR": {"MultiStepLR": {"milestones": [2, 1], "gamma": 0.3}},
    "ExponentialLR": {"ExponentialLR": {"gamma": 0.7}},
    "CosineAnnealingLR": {"CosineAnnealingLR": {"T_max": 2,
                                                "eta_min": 1e-5}},
    "CosineAnnealingWarmRestarts": {"CosineAnnealingWarmRestarts": {
        "T_0": 2, "T_mult": 1, "eta_min": 1e-5}},
    "CosineAnnealingWarmRestarts-Tmult2": {"CosineAnnealingWarmRestarts": {
        "T_0": 1, "T_mult": 2, "eta_min": 0.0}},
    "CyclicLR": {"CyclicLR": {"base_lr": 1e-4, "max_lr": 1e-2,
                              "step_size_up": 3, "step_size_down": 2}},
    "CyclicLR-symmetric": {"CyclicLR": {"max_lr": 1e-2,
                                        "step_size_up": 4}},
    "OneCycleLR-epochs": {"OneCycleLR": {"max_lr": 0.1, "epochs": EPOCHS,
                                         "pct_start": 0.3}},
    "OneCycleLR-total": {"OneCycleLR": {"max_lr": 0.05, "total_steps": 7,
                                        "pct_start": 0.25, "div_factor": 10,
                                        "final_div_factor": 100}},
    "ReduceLROnPlateau": {"ReduceLROnPlateau": {"patience": 1}},
    "configs/train/train_stage1.yaml": None,
}


def _schedule_config(name):
    if SCHEDULES[name] is None:
        from ei_nexus_tpu.utils import load_config
        return load_config("configs/train_EIM_stage1_EC_SP_MNN.yaml"
                           ).train.to_dict()["scheduler"]
    return {"type": name.split("-")[0], **SCHEDULES[name]}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    """lr(step) over 3 epochs of 4 steps (and a little beyond), step for
    step; JAX's schedule is called as optax calls it, with an int32
    count."""
    cfg = _schedule_config(name)
    base = 1e-3
    js = jopt.build_schedule(cfg, base, steps_per_epoch=SPE)
    ts = topt.build_schedule(cfg, base, steps_per_epoch=SPE)
    got = [ts(step) for step in range(EPOCHS * SPE + 3)]
    want = [float(js(jnp.asarray(step, jnp.int32)))
            for step in range(EPOCHS * SPE + 3)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * base,
                               err_msg=name)
    assert all(isinstance(v, float) for v in got)
    if name != "ReduceLROnPlateau" and SCHEDULES[name] is not None:
        assert len(set(np.round(got, 12))) > 1, "the schedule never moved"
    assert topt.is_host_driven(cfg) == jopt.is_host_driven(cfg)


def test_warm_restarts_take_the_float32_cycle_index():
    """T_mult = 3 from T_0 = 1: epoch 121 opens cycle 5 (3**5 = 243 =
    2 * 121 + 1), which float64 logarithms put in cycle 4; the port takes
    the JAX package's float32 index."""
    cfg = {"type": "CosineAnnealingWarmRestarts",
           "CosineAnnealingWarmRestarts": {"T_0": 1, "T_mult": 3}}
    js = jopt.build_schedule(cfg, 1e-3, steps_per_epoch=1)
    ts = topt.build_schedule(cfg, 1e-3, steps_per_epoch=1)
    steps = range(0, 400)
    np.testing.assert_allclose(
        [ts(s) for s in steps],
        [float(js(jnp.asarray(s, jnp.int32))) for s in steps], rtol=1e-6,
        atol=1e-9)
    assert ts(121) == pytest.approx(1e-3)   # a restart


def test_unknown_types_raise():
    with pytest.raises(NotImplementedError):
        topt.build_schedule({"type": "PolynomialLR"}, 1e-3)
    with pytest.raises(NotImplementedError):
        topt.build_optimizer({"type": "RMSprop"},
                             [torch.nn.Parameter(torch.zeros(2))],
                             lambda s: 1e-3)


OPTIMIZERS = {
    "Adam": {"type": "Adam", "Adam": {"betas": [0.8, 0.99], "eps": 1e-8}},
    "Adam-wd": {"type": "Adam", "Adam": {"weight_decay": 1e-2}},
    "AdamW": {"type": "AdamW", "AdamW": {"weight_decay": 0.1,
                                         "betas": [0.9, 0.999]}},
    "SGD": {"type": "SGD", "SGD": {"momentum": 0.9}},
    "SGD-nesterov": {"type": "SGD", "SGD": {"momentum": 0.8,
                                            "nesterov": True}},
    "SGD-wd": {"type": "SGD", "SGD": {"momentum": 0.9,
                                      "weight_decay": 1e-2}},
    "SGD-nesterov-wd": {"type": "SGD", "SGD": {"momentum": 0.9,
                                               "nesterov": True,
                                               "weight_decay": 1e-2}},
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """5 updates with a moving lr (StepLR halving each step) and
    gradients that depend on the parameters, against the JAX package's
    optax chain; the port writes lr(step) into the optimizer before each
    update, as its training steps do."""
    cfg = OPTIMIZERS[name]
    sched_cfg = {"type": "StepLR", "StepLR": {"step_size": 1,
                                              "gamma": 0.5}}
    js = jopt.build_schedule(sched_cfg, 1e-2)
    ts = topt.build_schedule(sched_cfg, 1e-2)
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(size=(7, 5)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    A = rng.normal(size=(5, 5)).astype(np.float32)
    noise = [rng.normal(size=(7, 5)).astype(np.float32) for _ in range(5)]

    def grads(w, b, i):          # the same function on both sides
        return w @ A + noise[i], b * 2.0 + 0.5

    tx = jopt.build_optimizer(cfg, js)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p0["w"].copy())),
              torch.nn.Parameter(torch.from_numpy(p0["b"].copy()))]
    opt = topt.build_optimizer(cfg, params, ts)
    for i in range(5):
        gw, gb = grads(np.asarray(jp["w"]), np.asarray(jp["b"]), i)
        upd, jstate = tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tw, tb = grads(params[0].detach().numpy(), params[1].detach().numpy(),
                       i)
        params[0].grad = torch.from_numpy(np.ascontiguousarray(tw))
        params[1].grad = torch.from_numpy(np.ascontiguousarray(tb))
        topt.set_learning_rate(opt, ts(i))
        opt.step()
        assert topt.get_learning_rate(opt) == pytest.approx(ts(i))
        for k, p in zip(("w", "b"), params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{name} update {i} {k}")
    assert not np.allclose(params[0].detach().numpy(), p0["w"])


@pytest.mark.parametrize("kwargs", [
    dict(patience=2, cooldown=1),
    dict(patience=1, cooldown=2, factor=0.5, min_lr=2e-5),
    dict(mode="max", patience=1, threshold=0.05, threshold_mode="abs"),
    dict(patience=0, factor=0.5, eps=3e-4),
], ids=["cooldown", "min_lr", "max-abs", "eps"])
def test_plateau_controller_matches_jax(kwargs):
    """The controller's lr and state after each epoch, over a loss
    sequence with improvements, plateaus and relapses; then a state_dict
    round trip continues identically."""
    losses = [1.0, 0.9, 0.9, 0.91, 0.9, 0.95, 0.5, 0.5, 0.5, 0.5, 0.49,
              0.6, 0.6, 0.6, 0.6, 0.6, 0.2, 0.2, 0.2]
    if kwargs.get("mode") == "max":
        losses = [-x for x in losses]
    j = jopt.PlateauController(1e-3, **kwargs)
    t = topt.PlateauController(1e-3, **kwargs)
    lrs = []
    for i, x in enumerate(losses):
        lrs.append(t.step(x))
        assert lrs[-1] == j.step(x), i
        assert t.state_dict() == j.state_dict(), i
    assert len(set(lrs)) > 1, "the lr never dropped"
    u = topt.PlateauController(1e-3, **kwargs)
    u.load_state_dict(t.state_dict())
    for x in losses[:5]:
        assert u.step(x) == j.step(x)


def test_plateau_from_config_matches_jax():
    cfg = {"type": "ReduceLROnPlateau",
           "ReduceLROnPlateau": {"mode": "min", "factor": 0.2,
                                 "patience": 3, "cooldown": 1,
                                 "min_lr": 1e-6}}
    t = topt.PlateauController.from_config(cfg, 1e-3)
    j = jopt.PlateauController.from_config(cfg, 1e-3)
    assert vars(t) == vars(j)


def test_refusals():
    with pytest.raises(ValueError):
        topt.PlateauController(1e-3, mode="median")
    with pytest.raises(ValueError):
        topt.PlateauController(1e-3, factor=1.0)
    with pytest.raises(ValueError):
        topt.build_schedule({"type": "OneCycleLR",
                             "OneCycleLR": {"total_steps": 0, "epochs": 0}},
                            1e-3)


def test_host_driven_schedule_keeps_the_trainers_lr():
    """With ReduceLROnPlateau the training step leaves the optimizer's lr
    as the trainer set it; with a step-indexed schedule it writes
    lr(step) before each update."""
    from ei_nexus_tpu_torch.train.state import create_train_state
    from ei_nexus_tpu_torch.train.steps import _apply_gradients

    for stype, host in (("ReduceLROnPlateau", True), ("StepLR", False)):
        model = torch.nn.Linear(3, 2)
        state = create_train_state(
            model, (), {"type": "SGD", "SGD": {"momentum": 0.0}},
            {"type": stype, "StepLR": {"step_size": 1, "gamma": 0.5}}, 1e-2)
        assert state.host_lr == host
        topt.set_learning_rate(state.optimizer, 7e-3)
        for _ in range(2):
            model(torch.ones(1, 3)).sum().backward()
            _apply_gradients(state)
            state.optimizer.zero_grad()
        want = 7e-3 if host else state.schedule(1)
        assert topt.get_learning_rate(state.optimizer) == pytest.approx(want)
        assert state.step == 2
