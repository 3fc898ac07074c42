"""PPO with coupled Actor and Critic problems and a rollout env.

Port of ``examples/ppo/main.py``: a vectorized CartPole simulated on the
host in numpy (``VecCartPole``), an ``envs.Env`` (``PPOEnv``) that plays
``horizon`` steps of ``n_envs`` games with the current actor and critic,
reading each network's output back to the host once a step, and takes
GAE(lambda) advantages on the host into an ``rl.ExperienceBuffer``; the
actor (an ``MLP([64, 64, 2])`` policy, Adam at 3e-4, a clipped surrogate
plus 0.01 entropy) sits over the critic (``MLP([64, 64, 1])``, Adam at
1e-3, squared error to the returns), ``l2u={critic: [actor]}`` and no
``u2l``, so the actor takes its own gradient only. Both draw 256-row
minibatches of the newest rollout from the env, seeded by their step
counts. ``PPOEngine.train_step`` collects a fresh rollout every
``epochs_per_rollout`` steps, so ``compile_blocks`` would run it in driver
mode (``Engine.run_compiled``); the example has no such flag.

The numpy ``RandomState`` streams (the simulator's resets, one
``choice`` per env and step, the minibatch rows) are consumed in JAX's
order, so the rollouts are the JAX example's arrays. The observations stay
float32 and the networks cast them to their parameters' dtype.

    python -m betty_tpu_torch.examples.ppo
    python -m betty_tpu_torch.examples.ppo --device cpu --n_envs 4 --horizon 32 \\
        --train_iters 8 --epochs_per_rollout 4
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim
from betty_tpu_torch.envs import Env
from betty_tpu_torch.models import MLP
from betty_tpu_torch.module import from_torch
from betty_tpu_torch.rl import ExperienceBuffer
from betty_tpu_torch.utils import require_device


class VecCartPole:
    """Vectorized CartPole-v1 dynamics (the classic-control physics)."""

    def __init__(self, n_envs, seed=0):
        self.n = n_envs
        self.rng = np.random.RandomState(seed)
        self.state = self._reset_states(np.ones(self.n, bool))
        self.steps = np.zeros(self.n, np.int32)

    def _reset_states(self, mask):
        fresh = self.rng.uniform(-0.05, 0.05, size=(int(mask.sum()), 4))
        if not hasattr(self, "state"):
            return fresh.astype(np.float32)
        s = self.state.copy()
        s[mask] = fresh
        return s

    def step(self, actions):
        g, mc, mp, length, f, tau = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
        x, x_dot, th, th_dot = self.state.T
        force = np.where(actions == 1, f, -f)
        cos, sin = np.cos(th), np.sin(th)
        temp = (force + mp * length * th_dot**2 * sin) / (mc + mp)
        th_acc = (g * sin - cos * temp) / (length * (4.0 / 3.0 - mp * cos**2 / (mc + mp)))
        x_acc = temp - mp * length * th_acc * cos / (mc + mp)
        self.state = np.stack([x + tau * x_dot, x_dot + tau * x_acc,
                               th + tau * th_dot, th_dot + tau * th_acc], axis=1).astype(np.float32)
        self.steps += 1
        done = ((np.abs(self.state[:, 0]) > 2.4) | (np.abs(self.state[:, 2]) > 0.2095)
                | (self.steps >= 500))
        reward = np.ones(self.n, np.float32)
        if done.any():
            self.state = self._reset_states(done)
            self.steps[done] = 0
        return self.state, reward, done


class PPOEnv(Env):
    """Collects GAE(lambda) rollouts with the current actor and critic."""

    def __init__(self, n_envs=8, horizon=128, gamma=0.99, lam=0.95, seed=0):
        super().__init__()
        self.sim = VecCartPole(n_envs, seed)
        self.horizon, self.gamma, self.lam = horizon, gamma, lam
        self.rng = np.random.RandomState(seed + 1)
        self.buffer = ExperienceBuffer()
        self.mean_return = 0.0
        self.rollout = None

    def _outputs(self, problem, obs):
        """``problem``'s network on ``obs``, read back to the host."""
        return problem.module(torch.from_numpy(obs).to(self.device)).cpu().numpy()

    def step(self):
        actor, critic = self.actor, self.critic  # injected by the engine
        self.buffer.clear()
        obs = self.sim.state.copy()
        for _ in range(self.horizon):
            logits = self._outputs(actor, obs)
            values = self._outputs(critic, obs).squeeze(-1)
            probs = np.exp(logits - logits.max(axis=1, keepdims=True))
            probs /= probs.sum(axis=1, keepdims=True)
            actions = np.array([self.rng.choice(2, p=p) for p in probs], np.int32)
            logp = np.log(probs[np.arange(len(actions)), actions] + 1e-8)
            next_obs, reward, done = self.sim.step(actions)
            self.buffer.add(obs=obs, act=actions, logp=logp, rew=reward, done=done, val=values)
            obs = next_obs.copy()

        data = self.buffer.stacked()  # each (T, n_envs, ...)
        last_val = self._outputs(critic, obs).squeeze(-1)
        rew, done, val = data["rew"], data["done"], data["val"]
        adv = np.zeros_like(rew)
        gae = np.zeros(rew.shape[1], np.float32)
        for t in reversed(range(self.horizon)):
            nxt = last_val if t == self.horizon - 1 else val[t + 1]
            nonterm = 1.0 - done[t]
            delta = rew[t] + self.gamma * nxt * nonterm - val[t]
            gae = delta + self.gamma * self.lam * nonterm * gae
            adv[t] = gae
        ret = adv + val
        self.mean_return = float(rew.sum(axis=0).mean())
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)

        def flat(a):
            return a.reshape(-1, *a.shape[2:]).astype(np.float32)

        self.rollout = {"obs": flat(data["obs"]), "act": data["act"].reshape(-1),
                        "logp": flat(data["logp"]), "adv": flat(adv), "ret": flat(ret)}

    def minibatch(self, batch_size, seed):
        r = np.random.RandomState(seed)
        n = len(self.rollout["obs"])
        idx = r.randint(0, n, batch_size)
        return {k: v[idx] for k, v in self.rollout.items()}


class Actor(ImplicitProblem):
    def training_step(self, batch):
        logits = self.module(batch["obs"])
        logp_all = F.log_softmax(logits, dim=1)
        logp = logp_all.gather(1, batch["act"][:, None].long()).squeeze(-1)
        ratio = torch.exp(logp - batch["logp"])
        # jnp.clip's tie rule: maximum and minimum split a tie's gradient
        lo, hi = torch.full_like(ratio, 1 - 0.2), torch.full_like(ratio, 1 + 0.2)
        clipped = torch.minimum(torch.maximum(ratio, lo), hi)
        policy_loss = -torch.mean(torch.minimum(ratio * batch["adv"], clipped * batch["adv"]))
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=1))
        return {"loss": policy_loss - 0.01 * entropy, "entropy": entropy}

    def get_batch(self):
        return self._convert_batch(self.env.minibatch(256, self._count))


class Critic(ImplicitProblem):
    def training_step(self, batch):
        values = self.module(batch["obs"]).squeeze(-1)
        return torch.mean((values - batch["ret"]) ** 2)

    def get_batch(self):
        return self._convert_batch(self.env.minibatch(256, 10_000 + self._count))


class PPOEngine(Engine):
    epochs_per_rollout = 8

    def train_step(self):
        if (self.global_step - 1) % self.epochs_per_rollout == 0:
            self.env.step()  # a fresh rollout
        super().train_step()


def build_engine(args):
    device = require_device(args.device, "ppo")
    env = PPOEnv(n_envs=args.n_envs, horizon=args.horizon, seed=args.seed)

    def mlp(features, seed):
        return from_torch(MLP(4, features, device=device,
                              generator=torch.Generator(device=device).manual_seed(seed)))

    actor = Actor(name="actor", module=mlp([64, 64, 2], 0), optimizer=optim.adam(lr=3e-4),
                  config=Config(log_step=args.log_step))
    critic = Critic(name="critic", module=mlp([64, 64, 1], 1), optimizer=optim.adam(lr=1e-3),
                    config=Config(unroll_steps=1))
    engine = PPOEngine(config=EngineConfig(train_iters=args.train_iters),
                       problems=[actor, critic],
                       dependencies={"l2u": {critic: [actor]}, "u2l": {}}, env=env,
                       device=device)
    engine.epochs_per_rollout = args.epochs_per_rollout
    return engine


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_envs", type=int, default=8)
    p.add_argument("--horizon", type=int, default=128)
    p.add_argument("--train_iters", type=int, default=200)
    p.add_argument("--epochs_per_rollout", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_step", type=int, default=-1)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    print("mean rollout return:", engine.env.mean_return)
    return engine


if __name__ == "__main__":
    main()
