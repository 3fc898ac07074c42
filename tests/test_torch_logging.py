"""The port's logging sinks (``betty_tpu_torch/logging``) against the JAX
package's (``betty_tpu/logging``).

* The ``logger`` factory: ``"none"``/``"stdout"`` print only,
  ``"tensorboard"``/``"tb"`` the TensorBoard sink, ``"wandb"`` the W&B
  sink; where a sink's package does not import, the JAX factory's warning
  and the stdout logger.
* ``TensorBoardLogger``: the port and JAX write the same tags, steps and
  values (read back with tensorboard's ``EventAccumulator``), under the
  same ``betty_tensorboard/<time>_<host>`` directory of the working one.
* ``WandBLogger``: the same ``init`` arguments and ``log`` payloads as
  JAX's, through a stub ``wandb`` module.
* An engine with ``logger_type="tensorboard"`` (tutorial 3) writes every
  problem's metrics at its ``log_step``.
"""

import importlib
import logging
import socket
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu import logging as jlogging
from betty_tpu_torch import logging as tlogging
from betty_tpu_torch.logging.logger_base import LoggerBase


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores, and
    small ops spread over every core wait for all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def warnings_seen():
    handler = _Records()
    log = logging.getLogger("betty_tpu_torch")
    log.addHandler(handler)
    yield handler.messages
    log.removeHandler(handler)


def _scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def _one_dir(root):
    dirs = list((root / "betty_tensorboard").iterdir())
    assert len(dirs) == 1 and dirs[0].name.endswith("_" + socket.gethostname())
    return dirs[0]


@pytest.mark.parametrize("kind", ["none", "stdout", "tensorboard", "tb"])
def test_factory_choices(monkeypatch, tmp_path, kind):
    monkeypatch.chdir(tmp_path)
    sink = tlogging.logger(kind)
    if kind in ("tensorboard", "tb"):
        from betty_tpu_torch.logging.logger_tensorboard import TensorBoardLogger

        assert isinstance(sink, TensorBoardLogger)
        sink.writer.close()
        _one_dir(tmp_path)
    else:
        assert type(sink) is LoggerBase
        assert not (tmp_path / "betty_tensorboard").exists()


@pytest.mark.parametrize("kind,module,package", [
    ("tensorboard", "logger_tensorboard", "torch.utils.tensorboard"),
    ("tb", "logger_tensorboard", "torch.utils.tensorboard"),
    ("wandb", "logger_wandb", "wandb"),
])
def test_factory_falls_back_without_the_package(monkeypatch, warnings_seen, kind, module,
                                                package):
    monkeypatch.setitem(sys.modules, package, None)  # importing it raises ImportError
    monkeypatch.delitem(sys.modules, f"betty_tpu_torch.logging.{module}", raising=False)
    monkeypatch.delitem(sys.modules, f"betty_tpu.logging.{module}", raising=False)
    sink = tlogging.logger(kind)
    assert type(sink) is LoggerBase
    name = "wandb" if kind == "wandb" else "tensorboard"
    want = f"{name} is not installed; falling back to stdout logging"
    assert warnings_seen == [want]
    jsink = jlogging.logger(kind)  # the JAX factory takes the same fallback
    assert type(jsink).__name__ == "LoggerBase"


def test_tensorboard_logger_writes_what_jax_writes(monkeypatch, tmp_path):
    from betty_tpu.logging.logger_tensorboard import TensorBoardLogger as JTB
    from betty_tpu_torch.logging.logger_tensorboard import TensorBoardLogger as TTB

    steps = [(1, 0.75, 50.0), (2, 0.5, 62.5), (3, 0.25, 87.5)]
    for side, cls, arr in (("jax", JTB, jnp.asarray), ("port", TTB, torch.tensor)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        sink = cls()
        for step, loss, acc in steps:
            sink.log({"loss": arr(loss), "acc": np.float32(acc), "n": step,
                      "vector": arr([1.0, 2.0]), "name": "skipped"}, tag="reweight", step=step)
        sink.log({"loss": arr(0.125)}, step=4)
        sink.log(None, tag="reweight", step=5)
        sink.writer.close()
    got, want = _scalars(_one_dir(tmp_path / "port")), _scalars(_one_dir(tmp_path / "jax"))
    assert got == want
    assert sorted(got) == ["loss", "reweight/acc", "reweight/loss", "reweight/n"]
    assert got["reweight/loss"] == [(s, l) for s, l, _ in steps]


def _stub_wandb():
    stub = types.ModuleType("wandb")
    stub.run, stub.inits, stub.logged = None, [], []

    def init(**kwargs):
        stub.inits.append(kwargs)
        stub.run = object()

    stub.init = init
    stub.log = lambda payload, step=None: stub.logged.append((payload, step))
    return stub


def test_wandb_logger_payload_matches_jax(monkeypatch):
    payloads = {}
    for side, pkg, arr in (("jax", "betty_tpu", jnp.asarray), ("port", "betty_tpu_torch",
                                                                 torch.tensor)):
        stub = _stub_wandb()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        monkeypatch.delitem(sys.modules, f"{pkg}.logging.logger_wandb", raising=False)
        mod = importlib.import_module(f"{pkg}.logging.logger_wandb")
        sink = mod.WandBLogger(entity="team")
        mod.WandBLogger()  # a second sink joins the active run
        sink.log({"loss": arr(0.5), "acc": np.float64(75.0), "n": 3}, tag="classifier", step=7)
        sink.log({"loss": arr(0.25)}, step=8)
        sink.log(None, step=9)
        payloads[side] = (stub.inits, stub.logged)
        factory = importlib.import_module(f"{pkg}.logging").logger("wandb")
        assert type(factory).__name__ == "WandBLogger"
    assert payloads["port"] == payloads["jax"]
    assert payloads["port"][0] == [{"project": "betty_tpu", "entity": "team"}]
    assert payloads["port"][1] == [({"classifier/loss": 0.5, "classifier/acc": 75.0,
                                     "classifier/n": 3}, 7), ({"loss": 0.25}, 8)]


def test_engine_logs_to_tensorboard(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    t3 = importlib.import_module("betty_tpu_torch.tutorial.3_logging")
    engine = t3.build_engine(t3.parse_args(["--device", "cpu", "--train_iters", "200"]))
    engine.run()
    engine.logger.writer.close()
    got = _scalars(_one_dir(tmp_path))
    assert sorted(got) == ["classifier/loss", "reweight/acc", "reweight/loss"]
    assert all([s for s, _ in events] == [100, 200] for events in got.values())
    assert all(np.isfinite(v) for events in got.values() for _, v in events)
