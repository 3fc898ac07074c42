"""ImageNet data pruning and PPO of the JAX package and the port's, in
float64 from the same weights on the same batches.

* ``pruning``: the pruning program at ``tests/test_examples2.py``'s
  arguments (B4, 32x32, 10 classes, stages ``[1, 1]``, width 8, ``--gas 2``,
  EMA decay 0.9), 4 iterations: both problems' parameters, the EMA teacher
  and the running statistics within 1e-8, counts 4:2, an accumulation
  boundary at the end on both sides.
* ``pruning_augment``: the same with ``--augment device`` at 40 -> 32, the
  crops and flips of every classifier loss drawn from JAX's step key of
  the same problem and count (``Classifier.draws``).
* ``pruning_npz``: the program on a small classification npz (the meta
  split, ``--augment device``), 2 iterations, then ``top1`` equal to JAX's.
* ``ppo``: the PPO program at ``tests/test_examples2.py``'s arguments (4
  envs, horizon 32, 8 iterations, a rollout every 4): both problems'
  parameters within 1e-8, the last rollout's actions equal and its
  advantages and returns within 1e-8, counts 8:8, ``mean_return`` equal.

Run as a subprocess by the tests (float64 JAX must not leak into the
float32 test process):

    python tests/torch_pruning_impl.py pruning pruning_augment pruning_npz ppo
"""

import json
import math
import os
import sys
import tempfile
import types
import zlib
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from betty_tpu_torch import convert  # noqa: E402
from betty_tpu_torch.examples import imagenet_pruning as tprune  # noqa: E402
from betty_tpu_torch.examples import ppo as tppo  # noqa: E402
from betty_tpu_torch.models import ResNetV1  # noqa: E402
from betty_tpu_torch.utils import fold_in, tree_map  # noqa: E402
from torch_nas_impl import _max_err, load  # noqa: E402

TOL = 1e-8
PRUNING = dict(batch_size=4, image_size=32, num_classes=10, width=8, stages=[1, 1], lr=0.1,
               gas=2, ema_decay=0.9, train_size=32, meta_size=16, train_iters=4,
               strategy="default", log_step=-1, valid_step=1000, augment="none", crop_size=32,
               device_data=False, precision="fp32", data_dir=None)
PPO = dict(n_envs=4, horizon=32, train_iters=8, epochs_per_rollout=4, seed=0, log_step=-1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f64_loaders(problems):
    for p in problems:
        for dl in p.train_data_loader:
            dl.arrays = (np.asarray(dl.arrays[0], np.float64),) + tuple(dl.arrays[1:])


def _tf64(tree):
    return tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                    else t, tree)


def _argv(spec):
    argv = ["--device", "cpu"]
    for k, v in spec.items():
        if k in ("strategy", "device_data") or v is None:
            continue
        flag = "--data-dir" if k == "data_dir" else f"--{k}"
        argv += [flag, *map(str, v)] if isinstance(v, list) else [flag, str(v)]
    return argv


def jax_draws(key, batch):
    """The draws of ``betty_tpu``'s ``imagenet_train_transform`` from ``key``
    (its crop's and flip's keys, split as it splits them), as tensors."""
    k_crop, k_flip = jax.random.split(key)
    k_area, k_ratio, k_y, k_x = jax.random.split(k_crop, 4)
    draws = {"area": jax.random.uniform(k_area, (batch,), minval=0.08, maxval=1.0),
             "log_ratio": jax.random.uniform(k_ratio, (batch,), minval=math.log(3 / 4),
                                             maxval=math.log(4 / 3)),
             "y": jax.random.uniform(k_y, (batch,)), "x": jax.random.uniform(k_x, (batch,)),
             "flip": jax.random.bernoulli(k_flip, 0.5, (batch,))}
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def _jax_keyed_draws(names, counts):
    """The port's step seed of each (problem, count) -> JAX's draws from the
    step key of the same problem and count (a loss reads ``self.rng`` once,
    so it sees the step key itself)."""
    keys = {}
    for name in names:
        seed = zlib.crc32(name.encode()) & 0x7FFFFFFF
        for n in range(1, counts + 2):
            keys[fold_in(seed, n)] = jax.random.fold_in(jax.random.PRNGKey(seed), n)

    def draws(rng, images):
        return jax_draws(keys[int(rng)], images.shape[0])

    return draws


# ---------------------------------------------------------------------------
# ImageNet data pruning
# ---------------------------------------------------------------------------


def _student(spec):
    return ResNetV1(stage_sizes=tuple(spec["stages"]), num_classes=spec["num_classes"],
                    width=spec["width"])


def _port_states(jeng, net):
    """JAX's pruning states as the port's params and extra (float64)."""
    out = {}
    js = _np(jeng.states["classifier"])
    params, stats = convert.from_flax_net(
        {"params": js["params"], "batch_stats": js["extra"]["batch_stats"]}, net,
        dtype=torch.float64)
    teacher, _ = convert.from_flax_net(
        {"params": js["extra"]["teacher_params"], "batch_stats": js["extra"]["batch_stats"]},
        net, dtype=torch.float64)
    out["classifier"] = (params, {"batch_stats": stats, "teacher_params": teacher})
    out["reweight"] = (convert.from_flax_mwn(_np(jeng.states["reweight"]["params"]),
                                             dtype=torch.float64), {})
    return out


def _pruning_engines(spec):
    jmod = load("pruning_parity", "imagenet_pruning/main.py")
    jeng = jmod.build_engine(types.SimpleNamespace(**spec))
    jeng.states = jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, jeng.states)
    _f64_loaders(jeng.problems)
    teng = tprune.build_engine(tprune.parse_args(_argv(spec)))
    teng.states = _tf64(teng.states)
    _f64_loaders(teng.problems)
    net = _student(spec)
    for name, (params, extra) in _port_states(jeng, net).items():
        teng.states[name] = {**teng.states[name], "params": params, "extra": extra}
    if spec["augment"] == "device":
        teng.classifier.draws = _jax_keyed_draws(("classifier", "reweight"),
                                                 spec["train_iters"])
    return jeng, teng, net


def _pruning_errs(jeng, teng, net):
    want = _port_states(jeng, net)
    errs = {}
    for name, (params, extra) in want.items():
        got = teng.states[name]
        errs[name] = _max_err(params, got["params"])
        for key, tree in extra.items():
            errs[f"{name} {key}"] = _max_err(tree, got["extra"][key])
    return errs


def _moved(init, teng):
    return min(_max_err(init[n], teng.states[n]["params"]) for n in init)


def _run_pruning(spec):
    jeng, teng, net = _pruning_engines(spec)
    init = {n: dict(s["params"]) for n, s in teng.states.items()}
    teacher0 = dict(teng.states["classifier"]["extra"]["teacher_params"])
    jeng.run()
    teng.run()
    counts = {"classifier": teng.classifier.count, "reweight": teng.reweight.count}
    assert counts == {"classifier": jeng.classifier.count, "reweight": jeng.reweight.count}
    boundary = (teng.classifier.gradient_accumulation_boundary(),
                jeng.classifier.gradient_accumulation_boundary())
    teacher_moved = _max_err(teacher0, teng.states["classifier"]["extra"]["teacher_params"])
    extra = {"counts": counts, "boundary": boundary, "teacher_moved": teacher_moved,
             "ok_extra": boundary == (True, True) and teacher_moved > 0}
    return jeng, teng, net, _pruning_errs(jeng, teng, net), _moved(init, teng), extra


def case_pruning():
    _, _, _, errs, moved, extra = _run_pruning(PRUNING)
    extra["ok_extra"] &= extra["counts"] == {"classifier": 4, "reweight": 2}
    return errs, moved, extra, TOL


def case_pruning_augment():
    spec = dict(PRUNING, image_size=40, crop_size=32, augment="device")
    _, _, _, errs, moved, extra = _run_pruning(spec)
    return errs, moved, extra, TOL


def write_classification_npz(path, n_train=40, n_test=10, size=40, classes=5, seed=0):
    """A classification npz: uint8 NHWC images, int labels of every class."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(n_train + n_test, size, size, 3) * 255).astype(np.uint8)
    y = np.arange(n_train + n_test) % classes
    np.savez(path, x_train=x[:n_train], y_train=y[:n_train], x_test=x[n_train:],
             y_test=y[n_train:])


def case_pruning_npz():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "classification.npz")
        write_classification_npz(path)
        spec = dict(PRUNING, data_dir=path, meta_size=8, train_iters=2, crop_size=32,
                    augment="device", num_classes=5, image_size=40)
        jeng, teng, net, errs, moved, extra = _run_pruning(spec)
        jtop, ttop = jeng.validation(), teng.validation()
    extra.update({"validation": ttop, "jax": jtop})
    extra["ok_extra"] &= jtop == ttop and set(ttop) == {"top1"}
    return errs, moved, extra, TOL


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------


def _ppo_port_params(jeng):
    return {name: convert.from_flax_mlp(_np(jeng.states[name]["params"]), dtype=torch.float64)
            for name in ("actor", "critic")}


def case_ppo():
    jmod = load("ppo_parity", "ppo/main.py")
    jeng = jmod.build_engine(types.SimpleNamespace(**PPO))
    jeng.states = jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, jeng.states)
    teng = tppo.build_engine(tppo.parse_args(_argv(PPO)))
    teng.states = _tf64(teng.states)
    for name, params in _ppo_port_params(jeng).items():
        teng.states[name] = {**teng.states[name], "params": params}
    init = {n: dict(s["params"]) for n, s in teng.states.items()}
    jeng.run()
    teng.run()
    want = _ppo_port_params(jeng)
    errs = {name: _max_err(want[name], teng.states[name]["params"]) for name in want}
    jr, tr = jeng.env.rollout, teng.env.rollout
    for key in ("adv", "ret", "logp", "obs"):
        errs[f"rollout {key}"] = float(np.abs(jr[key] - tr[key]).max())
    counts = {"actor": teng.actor.count, "critic": teng.critic.count}
    extra = {"counts": counts, "mean_return": teng.env.mean_return,
             "ok_extra": (np.array_equal(jr["act"], tr["act"])
                          and counts == {"actor": 8, "critic": 8}
                          == {"actor": jeng.actor.count, "critic": jeng.critic.count}
                          and teng.env.mean_return == jeng.env.mean_return)}
    return errs, _moved(init, teng), extra, TOL


CASES = {"pruning": case_pruning, "pruning_augment": case_pruning_augment,
         "pruning_npz": case_pruning_npz, "ppo": case_ppo}


def main(cases):
    failed = []
    for case in cases:
        errs, moved, extra, tol = CASES[case]()
        ok = max(errs.values()) <= tol and moved > 0 and extra.pop("ok_extra", True)
        print(("OK " if ok else "FAIL ") + json.dumps({"case": case, "max_abs_err": errs,
                                                     "tol": tol, "moved": moved, **extra}),
              flush=True)
        if not ok:
            failed.append(case)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(CASES)))
