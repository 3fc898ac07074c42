"""Env: an external, host-side environment that feeds problems
(``betty_tpu/envs/env_base.py``): a task sampler for MAML-style programs,
a rollout generator for RL.

The engine sets ``env.engine``, calls ``configure_device`` with its
device and then ``initialize`` before the problems are initialized; every
problem reaches the env as ``self.env``, and the env reaches every problem
by name. ``step`` advances the environment; a custom ``Engine.train_step``
calls it (``examples/implicit_maml.py``). Batches that problems take from
an env go to the device through ``Problem._convert_batch``.
"""


class Env:
    def __init__(self):
        self.engine = None
        self.device = None

    def initialize(self):
        """Set up the environment (user-overridable)."""

    def configure_device(self, device):
        """The engine's ``torch.device``, before ``initialize``."""
        self.device = device

    def step(self):
        """Advance the environment (user-overridable)."""
