"""Engine checkpoints and bit-exact resume.

Counterpart of ``betty_tpu/checkpoint.py``. A checkpoint directory holds:

* ``step_<global_step>.pt``: one ``torch.save`` file of host tensors, a dict
  with every problem's state under its name (params, ``extra`` with
  BatchNorm's ``batch_stats``, ``opt_state`` (under ``param_groups``
  ``{"groups": [...]}``, one state a group), ``grad_acc``, ``last_grad``;
  integer leaves such as Adam's ``count`` and ``sched_step`` stay Python
  integers), ``__rollback__<name>`` for each live roll-back cache (between
  compiled blocks, the caches the ``BlockRunner`` carries), and
  ``__unroll_start__<name>`` / ``__unroll_batches__<name>`` (a list, one
  batch a micro-step) for an ``IterativeProblem`` caught mid-unroll whose
  loaders resume mid-epoch (``iter_from``). It is written to a ``.tmp`` name
  and moved into place.
* ``meta.json``: the host counters of ``_host_meta`` and the name of the
  tensor file, written through ``meta.json.tmp`` and ``os.replace`` after
  the tensor file, so a save cut at any point leaves a ``meta.json`` that
  names a whole file (the previous step's). Older step files, and the
  ``.tmp`` of a cut save, are removed once ``meta.json`` names the new one.

``restore_engine_state`` puts every tensor back on the engine's device in
the dtype of the tensor it replaces (a structure or shape mismatch raises,
naming both structures), restores the counters, and sets the loaders to
the saved position: ``ArrayLoader``-style loaders resume mid-epoch
(``set_epoch``, ``iter_from``, ``sync_cursor``); other iterables restart
their epoch, and their ``batches_served`` restarts with it.

Across ranks (a strategy over ``torch.distributed``,
``betty_tpu/checkpoint.py:54-144, 198-246``): every rank gathers the whole
tensors of its ZeRO/FSDP shards over ``dp``, or of its tp/ep/pp shards over
the model axis (pp: the stacked blocks of the stages) (``Problem.full_state``, a collective), rank 0 alone writes the
files, and
all ranks then meet at a barrier, so no rank reads a checkpoint before it
is whole. On restore every rank reads the same files and cuts its shards
from them (``Problem.shard_full_state``); the host counters are the same on
every rank. A mid-unroll ITD recording holds each rank's own batches: they
are saved concatenated in batch-rank order and each rank takes its part
back.
The directory must be one that every rank sees.

At a compiled-block boundary no unroll of an ITD child is live: the
schedule starts a block only where every such unroll lies wholly inside it
(``compile._Simulator._causally_complete``), so the child stands at an
unroll start (``_inner_loop_start``) and its next step discards whatever
it had recorded. The save writes a recording only where a step has begun
one that no parent step has consumed yet.
"""

import glob
import json
import os
from typing import Any, Dict

import torch

from betty_tpu_torch.utils import tree_map

META = "meta.json"


def to_host(tree):
    """A host copy of ``tree``: tensors to the CPU (always copied, so the
    copy does not follow a compiled block's in-place updates)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def structure(tree) -> str:
    """A readable description of a tree: keys, lengths, and each leaf's
    kind (a tensor's dtype and shape, or the Python type)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(v)}" for k, v in tree.items()) + "}"
    if isinstance(tree, (list, tuple)):
        open_, close = ("[", "]") if isinstance(tree, list) else ("(", ")")
        return open_ + ", ".join(structure(v) for v in tree) + close
    if isinstance(tree, torch.Tensor):
        return f"{str(tree.dtype).replace('torch.', '')}{list(tree.shape)}"
    return type(tree).__name__


def _same_structure(cur, new) -> bool:
    if isinstance(cur, dict):
        return isinstance(new, dict) and list(cur) == list(new) and all(
            _same_structure(cur[k], new[k]) for k in cur)
    if isinstance(cur, (list, tuple)):
        return (isinstance(new, (list, tuple)) and len(cur) == len(new)
                and all(_same_structure(a, b) for a, b in zip(cur, new)))
    if isinstance(cur, torch.Tensor):
        return isinstance(new, torch.Tensor) and tuple(cur.shape) == tuple(new.shape)
    return not isinstance(new, (dict, list, tuple, torch.Tensor))


def restore_like(current, saved, what: str):
    """``saved`` (host tensors) in the place of ``current``: each tensor on
    the device and in the dtype of the one it replaces, other leaves as
    saved. Raises ``ValueError`` naming both structures when they differ."""
    if not _same_structure(current, saved):
        raise ValueError(
            f"{what}: state structure mismatch; the checkpoint was saved from a "
            f"differently configured problem (another optimizer, solver or module).\n"
            f"  current:    {structure(current)}\n  checkpoint: {structure(saved)}")

    def put(cur, new):
        if isinstance(cur, dict):
            return {k: put(cur[k], new[k]) for k in cur}
        if isinstance(cur, (list, tuple)):
            return type(cur)(put(a, b) for a, b in zip(cur, new))
        if isinstance(cur, torch.Tensor):
            return new.to(device=cur.device, dtype=cur.dtype)
        return new

    return put(current, saved)


def _rollback_caches(engine) -> Dict[str, Any]:
    """Live roll-back caches by problem: between compiled blocks the
    runner's, otherwise each problem's ``_state_cache``."""
    runner = engine.block_runner
    if runner is not None and runner.live:
        return runner.live_caches()
    return {p.name: p._state_cache for p in engine.problems if p._state_cache is not None}


def _resumable(p) -> bool:
    return p.train_data_loader is not None and all(
        hasattr(dl, "iter_from") for dl in p.train_data_loader)


def _live_unroll(p) -> bool:
    """An ``IterativeProblem`` mid-unroll: a step of the unroll has run and
    no parent step has consumed the recording yet."""
    return (getattr(p, "_unroll_start_state", None) is not None
            and bool(getattr(p, "_unroll_batches", None)) and not p._inner_loop_start)


def _host_meta(engine, caches) -> Dict[str, Any]:
    return {
        "global_step": engine.global_step,
        "counts": {p.name: p._count for p in engine.problems},
        "epoch_counters": {p.name: p.epoch_counter for p in engine.problems
                           if p.epoch_counter},
        # iterator positions: ArrayLoader-backed problems resume mid-epoch
        "batches_served": {p.name: p.batches_served for p in engine.problems
                           if getattr(p, "batches_served", None)},
        # unroll-phase flags: a mid-unroll checkpoint re-runs on_inner_loop_start
        # (and re-caches roll-back state) only where the interrupted run would
        "inner_loop_start": {p.name: p._inner_loop_start for p in engine.problems},
        "rollback_cached": sorted(caches),
        # a parent of several children keeps the ready flags of the ones
        # that finished their unroll across iterations
        "ready": {p.name: list(p.ready) for p in engine.problems},
        # host-side reads of Problem.rng within the current count
        "host_rng": {p.name: [p._host_rng_calls, p._host_rng_last_count]
                     for p in engine.problems},
    }


def _all_ranks(engine, batch):
    """A rank's batch: under a mesh every rank's, concatenated in rank order
    (a collective)."""
    if engine.mesh is None:
        return batch
    from betty_tpu_torch.parallel import make_global_batch

    return make_global_batch(batch, engine.mesh)


def _own_rows(engine, batch):
    """This rank's part of a batch saved by ``_all_ranks``."""
    if engine.mesh is None:
        return batch
    from betty_tpu_torch.parallel import batch_sharding

    sharding = batch_sharding(engine.mesh)
    return tree_map(lambda x: sharding.local(x) if isinstance(x, torch.Tensor) else x, batch)


def _barrier(engine):
    if engine.mesh is not None:
        import torch.distributed as dist

        dist.barrier(group=engine.mesh.group)


def save_engine_state(engine, path: str):
    path = os.path.abspath(path)
    problems = {p.name: p for p in engine.problems}
    caches = _rollback_caches(engine)
    # whole tensors of every shard: every rank gathers (a collective), only
    # the writer copies them to the host
    keep = to_host if engine.is_rank_zero() else (lambda _tree: None)
    tensors = {name: keep(problems[name].full_state(s)) for name, s in engine.states.items()}
    for name, cache in caches.items():
        tensors[f"__rollback__{name}"] = keep(problems[name].full_state(cache))
    unroll_recorded = {}
    for p in engine.problems:
        if _live_unroll(p) and _resumable(p):
            tensors[f"__unroll_start__{p.name}"] = keep(p.full_state(p._unroll_start_state))
            tensors[f"__unroll_batches__{p.name}"] = [keep(_all_ranks(engine, b))
                                                      for b in p._unroll_batches]
            unroll_recorded[p.name] = len(p._unroll_batches)
    if engine.is_rank_zero():
        _write(engine, path, tensors, caches, unroll_recorded)
    _barrier(engine)


def _write(engine, path, tensors, caches, unroll_recorded):
    os.makedirs(path, exist_ok=True)
    name = f"step_{engine.global_step}.pt"
    torch.save(tensors, os.path.join(path, name + ".tmp"))
    os.replace(os.path.join(path, name + ".tmp"), os.path.join(path, name))
    meta = {**_host_meta(engine, caches), "file": name}
    if unroll_recorded:
        meta["unroll_recorded"] = unroll_recorded
    tmp = os.path.join(path, META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, META))
    # older steps, and what a cut save left behind
    for old in glob.glob(os.path.join(path, "step_*.pt*")):
        if os.path.basename(old) != name:
            os.remove(old)


def _restore_loaders(p, epochs, served):
    p.epoch_counter = list(epochs)
    p.batches_served = list(served)
    for i, dl in enumerate(p.train_data_loader):
        if hasattr(dl, "set_epoch"):
            dl.set_epoch(epochs[i])
        if hasattr(dl, "iter_from"):
            # ArrayLoader: resume mid-epoch at the exact batch
            p.train_data_iterator[i] = dl.iter_from(epochs[i], served[i])
            if hasattr(dl, "sync_cursor"):
                dl.sync_cursor(epochs[i], served[i])
        else:
            # a generic iterable restarts its epoch, and the served count
            # with it, or the next checkpoint would record batches never taken
            p.train_data_iterator[i] = iter(dl)
            p.batches_served[i] = 0


def restore_engine_state(engine, path: str):
    path = os.path.abspath(path)
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    saved = torch.load(os.path.join(path, meta["file"]), map_location="cpu", weights_only=True)
    problems = {p.name: p for p in engine.problems}

    def restore(p, current, saved_state, what):
        """``saved_state`` (whole tensors) cut to this rank's shards."""
        return p.shard_full_state(restore_like(p.full_state_like(current), saved_state, what))

    for name in engine.states:
        engine.states[name] = restore(problems[name], engine.states[name], saved[name],
                                      f"restore of problem {name!r}")
    engine.global_step = meta["global_step"]
    for p in engine.problems:
        name = p.name
        p._count = meta["counts"][name]
        p._inner_loop_start = meta["inner_loop_start"][name]
        p.ready = list(meta["ready"][name])
        p._host_rng_calls, p._host_rng_last_count = meta["host_rng"][name]
        p._state_cache = None
        if name in meta["rollback_cached"]:
            p._state_cache = restore(p, engine.states[name], saved[f"__rollback__{name}"],
                                     f"restore of the roll-back cache of {name!r}")
        if name in meta["epoch_counters"] and p.train_data_loader is not None:
            served = meta["batches_served"].get(name, [0] * len(p.train_data_loader))
            _restore_loaders(p, meta["epoch_counters"][name], served)
        if name in meta.get("unroll_recorded", {}):
            # the mid-unroll ITD recording: the differentiation start state
            # and the batches consumed since
            p._unroll_start_state = restore(
                p, engine.states[name], saved[f"__unroll_start__{name}"],
                f"restore of the unroll start state of {name!r}")
            p._unroll_batches = [p._convert_batch(_own_rows(engine, b))
                                 for b in saved[f"__unroll_batches__{name}"]]
            p._pending_unroll_reset = False
        elif hasattr(p, "_unroll_batches"):
            p._unroll_start_state, p._unroll_batches = None, []
            p._pending_unroll_reset = False
