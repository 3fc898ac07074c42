"""The port's functional optimizers against betty_tpu.optim (optax chains):
10-step trajectories within 1e-6 in float32, and ``adam_moments`` equal to
optax's raw ``mu``/``nu``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu import optim as joptim
from betty_tpu_torch import optim as toptim

STEPS = 10


def _params():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}


def _grad(params, t, lib):
    """A gradient that depends on the parameters and on the step."""
    rng = np.random.RandomState(100 + t)
    noise = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
    if lib == "jax":
        return {k: 0.3 * params[k] + jnp.asarray(noise[k]) for k in params}
    return {k: 0.3 * params[k] + torch.tensor(noise[k]) for k in params}


def _schedule(lib):
    if lib == "jax":
        return lambda step: 0.05 * 0.5 ** (step // 4)
    return lambda step: 0.05 * 0.5 ** (step // 4)


OPTS = {
    "sgd": dict(lr=0.1),
    "sgd_momentum_wd": dict(lr=0.1, momentum=0.9, weight_decay=0.01),
    "sgd_nesterov": dict(lr=0.1, momentum=0.9, nesterov=True),
    "adam": dict(lr=0.01),
    "adam_l2": dict(lr=0.01, weight_decay=0.05),
    "adamw": dict(lr=0.01, weight_decay=0.05),
    "adam_schedule": dict(lr=0.05, schedule=True),
}


def _make(name, lib):
    kw = dict(OPTS[name])
    mod = joptim if lib == "jax" else toptim
    if kw.pop("schedule", False):
        kw["schedule"] = _schedule(lib)
    factory = name.split("_")[0]
    return getattr(mod, factory)(**kw)


@pytest.mark.parametrize("name", list(OPTS))
def test_trajectory_matches_optax(name):
    p0 = _params()
    jopt, topt = _make(name, "jax"), _make(name, "torch")
    assert jopt.kind == topt.kind
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for t in range(STEPS):
        ju, js = jopt.update(_grad(jp, t, "jax"), js, jp, sched_step=jnp.asarray(t))
        tu, ts = topt.update(_grad(tp, t, "torch"), ts, tp, sched_step=t)
        jp = {k: jp[k] + ju[k] for k in jp}
        tp = {k: tp[k] + tu[k] for k in tp}
    for k in p0:
        assert np.max(np.abs(tp[k].numpy() - np.asarray(jp[k]))) <= 1e-6, k
    if topt.kind == "adam":
        jmu, jnu = jopt.adam_moments(js)
        tmu, tnu = topt.adam_moments(ts)
        for k in p0:
            np.testing.assert_allclose(tmu[k].numpy(), np.asarray(jmu[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tnu[k].numpy(), np.asarray(jnu[k]), rtol=1e-6, atol=1e-7)


def test_adam_moments_requires_adam():
    opt = toptim.sgd(lr=0.1)
    with pytest.raises(ValueError, match="Adam"):
        opt.adam_moments(opt.init({"w": torch.zeros(2)}))
