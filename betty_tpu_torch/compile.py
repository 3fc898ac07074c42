"""Compiled blocks: one steady meta-period captured once as a CUDA graph and
replayed once a period.

Counterpart of ``betty_tpu/compile.py``. Every quantity that shapes the
schedule (``unroll_steps``, ``gradient_accumulation``, ``roll_back``) is
static, so the driver's step recursion (``Problem.step_normal`` /
``step_after_roll_back``) is simulated once on the host (``_Simulator``):
the result is the event list of one steady-state period, its length in
engine iterations and the phase it starts from, exactly the JAX package's.
``compress`` groups runs of identical leaf steps into segments as JAX's
does (there they become ``lax.scan``s; here a segment is a loop).

``BlockRunner`` runs the period function: the events in order, each
through the same update function as driver mode, with the roll-back cache
carried as references inside the period. On a CUDA device it runs the
period twice eagerly, on copies of the state, as warm-up (cuBLAS and cuDNN
choose their algorithms and workspaces there), captures it once into a
``torch.cuda.CUDAGraph`` that ends by copying the new states (and a
roll-back cache that crosses periods) into the static tensors it read, and
then replays the graph once a period. Between replays the host only
refreshes static inputs: the period's batch index rows (one int64 device
buffer per problem, filled from pinned memory) or, for loaders with host
code, the batches themselves; the per-step scalars (scheduled learning
rates, Adam's bias corrections); and the seeds of the dropout generators,
a pool registered with the graph and reseeded before each replay (the
reinforce solver's direction generator joins the same pool). Each of
those values is a function of an integer (a count, a scheduler step) that
advances by a constant every period; the warm-up periods give each its
advance, and the capture is checked against them. A capture that fails
raises: nothing falls back to driver mode.

Under ``EngineConfig(donate_state=True)`` the runner donates the state,
by JAX's rule (``betty_tpu/compile.py:400-409``: no ``IterativeProblem``
and no roll-back cache, ``BlockRunner.donate``): the engine's state is
the static state (no copy), the period's updates write into it
(``Problem.build_update_fn(donate=True)``), so the captured graph ends with
nothing to copy, and the warm-up periods run in place on it from a host
copy that puts its values back before the capture. No second copy of the
state lives on the card.

An ``IterativeProblem`` child under a ``first_order=False`` parent is
replayed inside the period as in driver mode: the period records the
child's state at its ``inner_loop_start`` event and the batches its later
events take, and hands them to the parent's event as ``itd_data``
(``betty_tpu/compile.py``'s ``itd_start``/``itd_batches``). The schedule
only starts a block where every such unroll lies wholly inside it. On the
card the replay and its double backward are captured with the rest of the
period and read the state the graph owns.

On the CPU (tests) the runner runs the same period function eagerly each
period, fed from the same static buffers and generator pool, and checks
the values each step reads against the ones it wrote.

Between blocks the engine's states are the runner's live state (on the
card the static tensors), and ``live_caches`` hands out the roll-back
caches the blocks carry, so a checkpoint saved there (``checkpoint.py``)
holds the live state. A run resumed from it builds a new runner, which
captures a new graph; its per-step values and seeds derive from the
restored counts and integer leaves, as every period's do.

Under a strategy over ``torch.distributed`` (data, tensor, expert,
pipeline or sequence parallel) the period's update functions make their
collectives (``parallel/collectives.py``: the batch reductions, tp/ep's
model-axis sums and gathers, pp's ring shifts and sp's sequence gathers)
as in driver mode: on the CPU eagerly, on the card
inside the captured graph, which replays them (PyTorch captures NCCL
collectives into a CUDA graph). A capture that fails
under a strategy raises an error naming the strategy and the failure;
nothing falls back to driver mode. With more than one rank every loader
takes the host data path (the batches copied into the static inputs), as
the JAX package's multi-process blocks stage batches on the host
(``betty_tpu/compile.py:357-359``): a rank's loader holds its own shard.
"""

from dataclasses import dataclass, field, replace
import time
from typing import List

import numpy as np
import torch

from betty_tpu_torch import utils
from betty_tpu_torch.data.loader import ArrayLoader
from betty_tpu_torch.problems import problem as problem_mod
from betty_tpu_torch.problems.iterative import unroll_data
from betty_tpu_torch.problems.problem import Problem, _CtxBinding, itd_child
from betty_tpu_torch.utils import StepSeed

# ---------------------------------------------------------------------------
# schedule simulation
# ---------------------------------------------------------------------------


@dataclass
class Event:
    name: str
    apply_update: bool
    advance_sched: bool
    inner_loop_start: bool = False
    rollback_recover: bool = False
    reuse_batch: bool = False
    count_offset: int = 0  # problem-local count at execution time (post-inc)
    # this recover's cache-creating inner_loop_start precedes it within the
    # period; when False the cache comes from the previous period
    cache_sure: bool = False


@dataclass
class _SimState:
    count: int = 0
    inner_loop_start: bool = True
    ready: List[bool] = field(default_factory=list)


class _Simulator:
    """Replays the driver recursion symbolically to extract the event list
    of one steady-state period."""

    MAX_ITERS = 4096

    def __init__(self, engine):
        self.engine = engine
        self.problems = {p.name: p for p in engine.problems}
        self.state = {p.name: _SimState(ready=[False] * len(p.children))
                      for p in engine.problems}
        self.events: List[Event] = []

    def phase(self):
        return tuple(
            (s.count % (self.problems[n]._unroll_steps * self.problems[n].gas),
             s.inner_loop_start, tuple(s.ready))
            for n, s in sorted(self.state.items()))

    def run(self):
        """``(events of one steady-state cycle, its length in engine
        iterations, the phase at the cycle start)``. The cycle need not pass
        through the t=0 phase; among its possible start iterations the first
        causally complete one is taken: every hypergradient event is preceded
        within the period by events of all its path intermediates."""
        def counts():
            return {n: s.count for n, s in self.state.items()}

        snaps = [(self.phase(), 0, counts())]  # after k iters: phase/events/counts
        index = {snaps[0][0]: 0}
        for it in range(self.MAX_ITERS):
            for leaf in self.engine.leaves:
                self.sim_step(leaf)
            ph = self.phase()
            if ph in index:
                j = index[ph]
                end_counts = counts()
                delta = {n: end_counts[n] - snaps[j][2][n] for n in end_counts}
                return self._extract_cycle(snaps, j, it + 1 - j, delta)
            index[ph] = len(snaps)
            snaps.append((ph, len(self.events), counts()))
        raise RuntimeError("Could not find a periodic schedule within "
                           f"{self.MAX_ITERS} engine iterations; use driver mode.")

    def _extract_cycle(self, snaps, j, period, delta):
        ev_j, ev_end = snaps[j][1], len(self.events)
        for m in range(j, j + period):
            ph_m, ev_m, base_m = snaps[m]
            head = self.events[ev_m:ev_end]
            tail = self.events[ev_j:ev_m]  # wraps into the next period
            if not self._causally_complete(head + tail):
                continue
            # count_offset is relative to the live counts at period entry;
            # wrapped events re-occur one period later
            out = [replace(e, count_offset=e.count_offset - base_m[e.name]) for e in head]
            out += [replace(e, count_offset=e.count_offset + delta[e.name] - base_m[e.name])
                    for e in tail]
            return out, period, ph_m
        raise RuntimeError(
            "The schedule's steady-state cycle has no causally-complete block boundary (a "
            "hypergradient step would precede its path intermediates' batches in every "
            "rotation); use driver mode.")

    def _causally_complete(self, events):
        done = set()
        started = set()  # problems whose inner_loop_start occurred in-block
        for e in events:
            p = self.problems[e.name]
            if e.reuse_batch and e.name not in done:
                return False
            if p._paths and any(q.name not in done for q in p._path_intermediates()):
                return False
            # ITD parents replay their children's batches since the unroll
            # start: the whole unroll must sit inside the block
            if any(itd_child(c) and c.name not in started for c in p.children):
                return False
            if e.inner_loop_start:
                started.add(e.name)
            done.add(e.name)
        return True

    # -- mirrors Problem.step -------------------------------------------
    def sim_step(self, p):
        self.sim_step_normal(p)
        s = self.state[p.name]
        if s.count % (p._unroll_steps * p.gas) == 0:
            self.sim_step_after_roll_back(p)

    def sim_step_normal(self, p):
        s = self.state[p.name]
        if not all(s.ready):
            return
        ev = Event(p.name, apply_update=False, advance_sched=not p._roll_back)
        if s.inner_loop_start:
            ev.inner_loop_start = True
            s.inner_loop_start = False
        s.count += 1
        ev.count_offset = s.count
        ev.apply_update = s.count % p.gas == 0
        self.events.append(ev)

        if s.count % (p._unroll_steps * p.gas) == 0:
            for parent in p.parents:
                idx = parent.children.index(p)
                self.state[parent.name].ready[idx] = True
                self.sim_step_normal(parent)
            s.inner_loop_start = True
        s.ready = [False] * len(p.children)

    def sim_step_after_roll_back(self, p):
        s = self.state[p.name]
        if not all(s.ready):
            return
        if p._roll_back:
            self.events.append(Event(p.name, apply_update=s.count % p.gas == 0,
                                     advance_sched=True, rollback_recover=True,
                                     reuse_batch=True, count_offset=s.count))
            for parent in p.parents:
                idx = parent.children.index(p)
                self.state[parent.name].ready[idx] = True
                self.sim_step_after_roll_back(parent)
        s.ready = [False] * len(p.children)


# ---------------------------------------------------------------------------
# segment compression
# ---------------------------------------------------------------------------


@dataclass
class Segment:
    events: List[Event]
    is_scan: bool

    @property
    def name(self):
        return self.events[0].name


MIN_SCAN_RUN = 4


def compress(events: List[Event], problems) -> List[Segment]:
    """Runs of at least ``MIN_SCAN_RUN`` identical plain leaf steps become
    one segment (``is_scan``), every other event a segment of its own."""
    segments: List[Segment] = []
    i = 0
    while i < len(events):
        ev = events[i]
        p = problems[ev.name]
        scannable = (not ev.inner_loop_start and not ev.rollback_recover
                     and not ev.reuse_batch and not p._paths)
        j = i
        if scannable:
            while (j + 1 < len(events)
                   and events[j + 1].name == ev.name
                   and events[j + 1].apply_update == ev.apply_update
                   and events[j + 1].advance_sched == ev.advance_sched
                   and not events[j + 1].inner_loop_start
                   and not events[j + 1].rollback_recover
                   and not events[j + 1].reuse_batch):
                j += 1
        run = events[i:j + 1]
        if scannable and len(run) >= MIN_SCAN_RUN:
            segments.append(Segment(run, is_scan=True))
            i = j + 1
        else:
            segments.append(Segment([ev], is_scan=False))
            i += 1
    return segments


# ---------------------------------------------------------------------------
# trees by path: states hold tensors and host integers (``sched_step``,
# Adam's ``count``)
# ---------------------------------------------------------------------------


_paths = utils.tree_paths


def _ints(tree):
    return {path: x for path, x in _paths(tree)
            if isinstance(x, (int, np.integer)) and not isinstance(x, bool)}


def _with_ints(tree, ints):
    """``tree`` with the integer leaves at ``ints``' paths replaced."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, prefix + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (i,)) for i, v in enumerate(node))
        return ints.get(prefix, node)

    return build(tree, ())


def _clone(tree):
    return utils.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _host_copy(tree):
    return utils.tree_map(lambda x: x.detach().to("cpu", copy=True)
                          if isinstance(x, torch.Tensor) else x, tree)


def _copy_into(static, new):
    """``static``'s tensors take ``new``'s values (same paths). An output
    that is itself a static tensor at another path is cloned first, so no
    copy reads a buffer another copy already wrote."""
    dst = dict(p for p in _paths(static) if isinstance(p[1], torch.Tensor))
    src = dict(p for p in _paths(new) if isinstance(p[1], torch.Tensor))
    if set(dst) != set(src):
        raise RuntimeError(f"compiled block: the period changed the state's structure "
                           f"({sorted(set(dst) ^ set(src))[:4]})")
    storages = {t.untyped_storage().data_ptr() for t in dst.values()}
    pending = []
    for path, d in dst.items():
        s = src[path]
        if s is d:
            continue
        if s.untyped_storage().data_ptr() in storages:
            s = s.clone()
        pending.append((d, s))
    for d, s in pending:
        d.copy_(s)


# ---------------------------------------------------------------------------
# per-step host values
# ---------------------------------------------------------------------------


class _StepValues:
    """What one period reads from the host, in call order: scalars
    ``fn(n)`` and dropout generators seeded with (``StepSeed``) seeds.
    Without ``slots`` the values are made as driver mode makes them; with
    ``slots`` they come from its static buffers and generator pool."""

    def __init__(self, slots=None):
        self.slots = slots
        self.scalars = []  # (fn, n, dtype)
        self.seeds = []

    def scalar(self, fn, n, dtype, device):
        i = len(self.scalars)
        self.scalars.append((fn, int(n), dtype))
        if self.slots is None:
            return torch.full((), float(fn(n)), dtype=dtype, device=device)
        return self.slots.scalar(i, dtype)

    def generator(self, seed, device):
        i = len(self.seeds)
        self.seeds.append(seed)
        if self.slots is None:
            return torch.Generator(device=device).manual_seed(int(seed))
        return self.slots.generators[i]


def _seed_key(seed):
    """``(derivation, n)`` of a seed: a ``StepSeed``'s base and folds and its
    count; a plain seed is its own derivation, at count 0."""
    if isinstance(seed, StepSeed):
        return (seed.base, seed.chain), seed.n
    return int(seed), 0


class _Slots:
    """The static inputs of the per-step values: one buffer per dtype for
    the scalars and one generator per dropout forward. ``plan(r)`` gives
    the values of the period ``r`` periods after the first warm-up one."""

    def __init__(self, first: _StepValues, second: _StepValues, device):
        if [d for _, _, d in first.scalars] != [d for _, _, d in second.scalars] or \
                len(first.seeds) != len(second.seeds):
            raise RuntimeError("compiled block: two warm-up periods read different per-step "
                               "values; the period is not steady")
        self.fns = [fn for fn, _, _ in first.scalars]
        self.n0 = [n for _, n, _ in first.scalars]
        self.dn = [b[1] - a[1] for a, b in zip(first.scalars, second.scalars)]
        self.seed_dn = []
        for (k1, n1), (k2, n2) in zip(map(_seed_key, first.seeds), map(_seed_key, second.seeds)):
            if k1 != k2:
                raise RuntimeError("compiled block: a dropout seed of the period is not "
                                   "derived from a step count; the period is not steady")
            self.seed_dn.append(n2 - n1)
        self.seeds = first.seeds
        self.where = []  # scalar i -> (dtype, index in its buffer)
        sizes = {}
        for _, _, dtype in first.scalars:
            self.where.append((dtype, sizes.get(dtype, 0)))
            sizes[dtype] = sizes.get(dtype, 0) + 1
        self.buffers = {dt: torch.zeros(n, dtype=dt, device=device) for dt, n in sizes.items()}
        self.generators = [torch.Generator(device=device) for _ in first.seeds]

    def scalar(self, i, dtype):
        dt, j = self.where[i]
        if dt != dtype:
            raise RuntimeError("compiled block: a per-step scalar changed its dtype")
        return self.buffers[dt][j]

    def plan(self, r):
        """``(n of each scalar, its value, each generator's seed)`` for
        period ``r``."""
        ns = [n + r * d for n, d in zip(self.n0, self.dn)]
        values = [fn(n) for fn, n in zip(self.fns, ns)]
        seeds = [s.at(s.n + r * d) if isinstance(s, StepSeed) else int(s)
                 for s, d in zip(self.seeds, self.seed_dn)]
        return ns, values, seeds

    def write(self, r):
        """Fill the buffers and reseed the generators for period ``r``;
        returns what was written."""
        ns, values, seeds = self.plan(r)
        for dt, buf in self.buffers.items():
            host = [float(v) for v, (d, _) in zip(values, self.where) if d == dt]
            src = torch.tensor(host, dtype=dt)
            if buf.device.type == "cuda":
                src = src.pin_memory()
            buf.copy_(src, non_blocking=True)
        for g, seed in zip(self.generators, seeds):
            g.manual_seed(seed)
        return ns, values, seeds

    def check(self, record: _StepValues, r):
        """Raise unless ``record`` read period ``r``'s values: the counts of
        its scalars and its generators' seeds."""
        ns, _, seeds = self.plan(r)
        got_ns = [n for _, n, _ in record.scalars]
        got_seeds = [int(s) for s in record.seeds]
        if got_ns != ns or got_seeds != seeds:
            raise RuntimeError(f"compiled block: period {r} read other per-step values than "
                               f"the runner wrote (counts {got_ns[:6]} against {ns[:6]}, "
                               f"{sum(a != b for a, b in zip(got_seeds, seeds))} seeds differ)")


# ---------------------------------------------------------------------------
# block runner
# ---------------------------------------------------------------------------


class BlockRunner:
    """Runs the periodic schedule, ``periods`` periods a block: on a CUDA
    device one graph replay a period, on the CPU the period function
    eagerly. ``captures``, ``replays`` (CUDA) and ``periods_run`` count what
    it did; ``capture_seconds`` is the time of the warm-up periods and the
    capture, ``warmup_seconds`` the warm-up periods' part of it. ``donate``:
    the state is updated in place (``EngineConfig.donate_state`` under
    JAX's rule)."""

    def __init__(self, engine, periods: int = 1, schedule_only: bool = False):
        self.engine = engine
        self.periods = max(1, int(periods))
        self.problems = {p.name: p for p in engine.problems}
        self.events, self.period, self.initial_phase = _Simulator(engine).run()
        if schedule_only:
            return
        started = set()
        for e in self.events:
            if e.rollback_recover:
                e.cache_sure = e.name in started
                started.discard(e.name)
            if e.inner_loop_start:
                started.add(e.name)
        self.segments = compress(self.events, self.problems)
        self.count_delta = {name: max((e.count_offset for e in self.events if e.name == name),
                                      default=0) for name in self.problems}
        # batches a period takes from each problem's loader
        self.takes = {name: sum(1 for e in self.events if e.name == name and not e.reuse_batch)
                      for name in self.problems}
        # device-resident ArrayLoaders feed index rows; the gathers run
        # inside the period. Others are read on the host and copied in.
        self.fastpath = {}
        for name, p in self.problems.items():
            dl = p.train_data_loader
            if (dl is not None and len(dl) == 1 and isinstance(dl[0], ArrayLoader)
                    and dl[0].device is not None and dl[0].drop_last
                    and getattr(dl[0], "postprocess_is_identity",
                                type(dl[0]).postprocess is ArrayLoader.postprocess)
                    and type(p).get_batch is Problem.get_batch
                    and not p.is_implemented("epoch_callback")
                    # several ranks: the host-staging path
                    and (engine.mesh is None or engine.mesh.world == 1)):
                self.fastpath[name] = dl[0]
        self.itd_names = {name for name, p in self.problems.items() if itd_child(p)}
        # JAX's rule: an IterativeProblem or a roll-back cache holds references
        # to old states, which donation would overwrite
        self.donate = bool(engine.config.donate_state and not any(
            hasattr(p, "replay_unroll") or p._roll_back for p in self.problems.values()))
        self.on_card = engine.device.type == "cuda"
        self.captures = 0
        self.replays = 0
        self.periods_run = 0
        self.capture_seconds = self.warmup_seconds = None
        self.finalized = False
        self._slots = None
        self._graph = None
        self._last_rows = {}

    def live_phase(self):
        """Current phase of the engine's problems (driver warm-up runs until
        it equals ``initial_phase``)."""
        return tuple((p._count % (p._unroll_steps * p.gas), p._inner_loop_start,
                      tuple(p.ready)) for _, p in sorted(self.problems.items()))

    # -- host side ---------------------------------------------------------
    def _collect(self):
        """One period's data: index rows of the fast-path loaders, batches
        of the others (read as driver mode reads them)."""
        out = {}
        for name, m in self.takes.items():
            if m == 0:
                continue
            if name in self.fastpath:
                out[name] = self.fastpath[name].take_indices(m)
            else:
                out[name] = [self.problems[name].get_batch() for _ in range(m)]
        return out

    def _batches(self, collected):
        """The period's batches, made eagerly from ``collected``."""
        out = {}
        for name, data in collected.items():
            if name in self.fastpath:
                ld = self.fastpath[name]
                idx = torch.as_tensor(data, device=ld.device)
                out[name] = [ld.gather(idx[j]) for j in range(len(data))]
            else:
                out[name] = data
        return out

    def _static_batches(self):
        """The period's batches, read from the static inputs."""
        out = {name: [ld.gather(self._idx[name][j]) for j in range(self.takes[name])]
               for name, ld in self.fastpath.items() if self.takes[name]}
        out.update(self._staged)
        return out

    def _feed(self, collected):
        """Copy a period's data into the static inputs (CUDA)."""
        for name, data in collected.items():
            if name in self.fastpath:
                self._idx[name].copy_(torch.from_numpy(data).pin_memory(), non_blocking=True)
            else:
                for static, batch in zip(self._staged[name], data):
                    _copy_into(static, batch)

    def _cache_validity(self, valid):
        """Roll-back cache validity after one period from ``valid``."""
        valid = dict(valid)
        for e in self.events:
            p = self.problems[e.name]
            if e.inner_loop_start and p._roll_back:
                valid[e.name] = True
            if e.rollback_recover:
                valid[e.name] = False
        return valid

    def _start(self):
        """First block: the static state, the carried roll-back caches and
        (CUDA) the static inputs."""
        engine = self.engine
        rb = sorted(n for n, p in self.problems.items() if p._roll_back)
        self._valid = {n: self.problems[n]._state_cache is not None for n in rb}
        valid_out = self._cache_validity(self._valid)
        for e in self.events:
            if e.rollback_recover and not e.cache_sure and self._valid[e.name] != \
                    valid_out[e.name]:
                raise RuntimeError(f"compiled block: problem {e.name!r} has no roll-back cache "
                                   "at the first block boundary")
        self._valid_out = valid_out
        self._states = _clone(engine.states) if self.on_card and not self.donate else \
            engine.states
        self._cache = {}
        for n in rb:
            if valid_out[n] or self._valid[n]:
                c = self.problems[n]._state_cache
                c = c if c is not None else engine.states[n]
                self._cache[n] = _clone(c) if self.on_card else c
        engine.states = self._states
        if self.on_card:
            dev = engine.device
            self._idx = {n: torch.empty((self.takes[n], ld.batch_size), dtype=torch.int64,
                                        device=dev)
                         for n, ld in self.fastpath.items() if self.takes[n]}
            self._staged = {}

    def _cache_in(self, cache):
        return {n: c for n, c in cache.items() if self._valid[n]}

    def _warm_up(self, collected):
        """Two eager periods on copies of the state: the per-step values'
        advance a period and the integer leaves' advance; on CUDA, on the
        capture stream, so that libraries set up their algorithms and
        workspaces there. Under ``donate`` the periods run in place on the
        static state, whose values a host copy puts back after."""
        counts0 = {n: p._count for n, p in self.problems.items()}
        counts1 = {n: c + self.count_delta[n] for n, c in counts0.items()}
        batches = self._batches(collected)
        records = (_StepValues(), _StepValues())
        if self.donate:  # no roll-back cache under donation
            host, states, cache = _host_copy(self._states), self._states, {}
        else:
            states, cache = _clone(self._states), _clone(self._cache_in(self._cache))
        ints = [(_ints(states), _ints(cache))]
        for rec, counts in zip(records, (counts0, counts1)):
            with utils.step_values(rec):
                states, cache, _ = self._period(states, cache, batches, counts)
            ints.append((_ints(states), _ints(cache)))
        del states, cache
        if self.donate:
            _copy_into(self._states, host)
        (s0, _), (s1, c1), (s2, c2) = ints
        self._int_base = (s1, c1)
        self._int_step = ({k: s2[k] - v for k, v in s1.items()},
                          {k: c2[k] - v for k, v in c1.items()})
        if any(s1[k] - v != self._int_step[0][k] for k, v in s0.items()):
            raise RuntimeError("compiled block: a state's step counters advanced by different "
                               "amounts in two periods; the period is not steady")
        self._slots = _Slots(*records, self.engine.device)

    def _host_ints(self, r):
        """Integer leaves of the states and carried caches after period
        ``r`` (0 is the first period of the runner)."""
        (s1, c1), (ds, dc) = self._int_base, self._int_step
        return ({k: v + r * ds[k] for k, v in s1.items()},
                {k: v + r * dc[k] for k, v in c1.items()})

    def _capture(self, collected):
        dev = self.engine.device
        self._staged = {n: [_clone(b) for b in data] for n, data in collected.items()
                        if n not in self.fastpath}
        self._feed(collected)
        graph = torch.cuda.CUDAGraph()
        for g in self._slots.generators:
            graph.register_generator_state(g)
        record = _StepValues(self._slots)
        counts0 = {n: p._count for n, p in self.problems.items()}
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                with utils.step_values(record):
                    states, cache, loss = self._period(self._states,
                                                       self._cache_in(self._cache),
                                                       self._static_batches(), counts0)
                _copy_into(self._states, states)
                _copy_into({n: self._cache[n] for n in cache}, cache)
        except Exception as e:
            if self.engine.mesh is None:
                raise
            raise RuntimeError(
                f"compiled blocks under strategy {self.engine.strategy!r}: capturing the "
                f"period with its collectives failed ({type(e).__name__}: {e}); run "
                "without compile_blocks") from e
        self._slots.check(record, self.periods_run)
        self._graph, self._loss = graph, loss
        self.captures += 1
        torch.cuda.current_stream(dev).wait_stream(self._stream)

    def _run_period(self):
        collected = self._collect()
        r = self.periods_run
        if self.on_card:
            if self._graph is None:
                t0 = time.perf_counter()
                self._stream = torch.cuda.Stream(self.engine.device)
                self._stream.wait_stream(torch.cuda.current_stream(self.engine.device))
                with torch.cuda.stream(self._stream):
                    self._warm_up(collected)
                torch.cuda.synchronize(self.engine.device)
                self.warmup_seconds = time.perf_counter() - t0
                # the static buffers were made on the warm-up stream
                torch.cuda.current_stream(self.engine.device).wait_stream(self._stream)
                self._slots.write(r)
                self._capture(collected)
                torch.cuda.synchronize(self.engine.device)
                self.capture_seconds = time.perf_counter() - t0
            else:
                self._feed(collected)
                self._slots.write(r)
            self._graph.replay()
            self.replays += 1
            loss = self._loss
        else:
            if self._slots is None:
                t0 = time.perf_counter()
                self._warm_up(collected)
                self.capture_seconds = self.warmup_seconds = time.perf_counter() - t0
            self._slots.write(r)
            record = _StepValues(self._slots)
            counts0 = {n: p._count for n, p in self.problems.items()}
            with utils.step_values(record):
                states, cache, loss = self._period(self._states, self._cache_in(self._cache),
                                                   self._batches(collected), counts0)
            self._slots.check(record, r)
            want = self._host_ints(r)
            if (_ints(states), _ints(cache)) != want:
                raise RuntimeError("compiled block: the state's step counters did not advance "
                                   "as in the warm-up periods")
            self._states, self._cache = states, {**self._cache, **cache}
        self._valid = self._valid_out
        self.periods_run += 1
        for name, p in self.problems.items():
            p._count += self.count_delta[name]
        self._set_cur_batches(collected)
        return loss

    def _set_cur_batches(self, collected):
        for name, data in collected.items():
            p = self.problems[name]
            if name in self.fastpath:
                self._last_rows[name] = data[-1]
            else:
                p.cur_batch = data[-1]

    def run_block(self):
        """Run ``periods`` periods; returns the last period's loss dicts by
        problem."""
        if self.periods_run == 0:
            self._start()
        elif self.on_card:
            # something outside the blocks (a validation hook) may have
            # replaced a state tensor: the static tensors take its value
            _copy_into(self._states, self.engine.states)
        else:
            self._states = self.engine.states
        for name, ld in self.fastpath.items():
            p = self.problems[name]
            ld.sync_cursor(p.epoch_counter[0], p.batches_served[0])
        for _ in range(self.periods):
            loss = self._run_period()
        states_ints, cache_ints = self._host_ints(self.periods_run - 1)
        self.engine.states = _with_ints(self._states, states_ints)
        for name, rows in self._last_rows.items():
            ld = self.fastpath[name]
            self.problems[name].cur_batch = ld.gather(torch.as_tensor(rows, device=ld.device))
        for name, ld in self.fastpath.items():
            p = self.problems[name]
            epoch, served = ld.cursor_position()
            if epoch != p.epoch_counter[0]:
                p.epoch_counter[0] = epoch
                ld.set_epoch(epoch)
            p.batches_served[0] = served
            p.train_data_iterator[0] = ld.iter_from(epoch, served)
        return loss

    @property
    def live(self) -> bool:
        """True between blocks: the roll-back caches are the runner's."""
        return self.periods_run > 0 and not self.finalized

    def live_caches(self):
        """The valid roll-back caches the blocks carry, by problem, with
        their integer leaves; the blocks go on."""
        _, cache_ints = self._host_ints(self.periods_run - 1)
        return {name: _with_ints(self._cache[name], {
                    k[1:]: v for k, v in cache_ints.items() if k[0] == name})
                for name, valid in self._valid.items() if valid}

    def finalize(self):
        """Hand the roll-back caches back to the problems, for the driver
        mode that follows the blocks."""
        if self.periods_run == 0:
            return
        caches = self.live_caches()
        for name in self._valid:
            self.problems[name]._state_cache = caches.get(name)
        self.finalized = True

    # -- the period function -------------------------------------------------
    def _period(self, states, cache, batches, counts0):
        """One period from ``states`` and the carried roll-back ``cache``
        (problem name -> state): ``(states, live caches at the end, last
        loss dict by problem)``. ``batches``: each problem's batches in the
        order of its events."""
        cur_batches = {}
        last_loss = {}
        cache = dict(cache)
        valid = dict(self._valid)
        taken = {name: 0 for name in batches}
        # ITD children: each unroll's start state, the count before its first
        # micro-step, and the batches taken since
        itd_start, itd_batches = {}, {}
        for seg in self.segments:
            p = self.problems[seg.name]
            for ev in seg.events:
                if ev.inner_loop_start:
                    states = self._run_inner_loop_start(p, states)
                    if p._roll_back:
                        cache[p.name] = states[p.name]
                        valid[p.name] = True
                    if p.name in self.itd_names:
                        # after the hook, as driver mode records it
                        itd_start[p.name] = (states[p.name],
                                             counts0[p.name] + ev.count_offset - 1)
                        itd_batches[p.name] = []
                if ev.rollback_recover:
                    if valid[p.name]:
                        states = {**states, p.name: cache[p.name]}
                    valid[p.name] = False
                if ev.reuse_batch:
                    batch = cur_batches[p.name]
                else:
                    batch = batches[p.name][taken[p.name]]
                    taken[p.name] += 1
                    cur_batches[p.name] = batch
                    if p.name in self.itd_names and not ev.rollback_recover:
                        itd_batches.setdefault(p.name, []).append(batch)
                path_batches = {q.name: cur_batches[q.name] for q in p._path_intermediates()}
                itd_data = {c.name: unroll_data(*itd_start[c.name], itd_batches[c.name])
                            for c in p.children if c.name in self.itd_names}
                rng = StepSeed.make(p._rng_seed, counts0[p.name] + ev.count_offset)
                upd = p._get_update_fn(ev.apply_update, ev.advance_sched)
                states, last_loss[p.name] = upd(states, batch, path_batches, itd_data, rng)
        live = {name: cache[name] for name, ok in valid.items() if ok}
        return states, live, last_loss

    def _run_inner_loop_start(self, p, states):
        """The problem's ``on_inner_loop_start`` hook on a context binding;
        edits it makes to any problem's params or extra are kept (under
        ``donate`` written into the state's own tensors)."""
        if not p.is_implemented("on_inner_loop_start"):
            return states
        ctx = {name: {"params": s["params"], "extra": s["extra"]} for name, s in states.items()}
        with _CtxBinding(ctx, None, None):
            p.on_inner_loop_start()
            final_ctx = problem_mod._TRACE_CTX
        put = utils.tree_copy_ if self.donate else (lambda _old, new: new)
        return {name: {**states[name], **{k: put(states[name][k], final_ctx[name][k])
                                          for k in ("params", "extra")}} for name in states}
