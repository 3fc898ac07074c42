"""Epoch-seeded minibatches over in-memory arrays
(``betty_tpu/data/loader.py::ArrayLoader``).

The shuffle of each epoch is ``np.random.RandomState(seed + epoch)
.permutation(n)``, the JAX loader's, so both packages serve the same
batches. With ``device`` set (``True`` for ``"cuda"``, or a device) the
arrays are moved to the device once and batches are gathered there.
``postprocess(batch)`` is applied to every batch served: subclasses
override it for augmentation (and set ``postprocess_is_identity`` when
their override is switched off).

The cursor API (``take_indices``, ``sync_cursor``, ``cursor_position``,
``iter_from``) serves compiled blocks: they take a period's index rows on
the host and gather the batches on the device inside the captured period,
then hand the stream back to the driver's iterator, so warm-up, blocks and
remainder consume one continuous stream of batches.

``prefetch_to_device`` keeps a few batches of any iterator in flight to the
card (``betty_tpu/data/loader.py::prefetch_to_device``).

``shard_loader`` gives a rank of a data-parallel run its examples
``rank::world`` of a loader (``betty_tpu/data/loader.py::shard_loader``);
``Problem.initialize`` applies it to every ``ArrayLoader`` under a strategy.
"""

import collections
import itertools

import numpy as np
import torch

from betty_tpu_torch.utils import require_device, tree_leaves, tree_map


class ArrayLoader:
    def __init__(self, *arrays, batch_size: int, seed: int = 0, drop_last: bool = True,
                 shuffle: bool = True, device=False):
        assert arrays, "ArrayLoader needs at least one array"
        n = len(arrays[0])
        assert all(len(a) == n for a in arrays)
        self.device = None
        if device is not False and device is not None:
            self.device = torch.device("cuda" if device is True else device)
            arrays = tuple(torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                                           else a).to(self.device) for a in arrays)
        self.arrays = arrays
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def _epoch_order(self, epoch):
        if self.shuffle:
            return np.random.RandomState(self.seed + epoch).permutation(self.n)
        return np.arange(self.n)

    def postprocess(self, batch):
        """Hook for subclasses (augmentation, ...), applied to every batch."""
        return batch

    def gather(self, idx):
        """The batch of index row ``idx``, before ``postprocess``."""
        batch = tuple(a[idx] for a in self.arrays)
        return batch[0] if len(batch) == 1 else batch

    def __iter__(self):
        yield from self.iter_from(self.epoch, 0)

    def take_indices(self, count: int) -> np.ndarray:
        """Advance the cursor by ``count`` batches and return their index
        rows, shape ``(count, batch_size)``, rolling over into the next
        epoch's order on exhaustion as ``Problem.get_batch`` does."""
        assert self.drop_last, "take_indices requires drop_last"
        out = []
        pos = getattr(self, "_fp_pos", None)
        order = getattr(self, "_fp_order", None)
        epoch = getattr(self, "_fp_epoch", self.epoch)
        while len(out) < count:
            if order is None or pos + self.batch_size > self.n:
                if order is not None:
                    epoch += 1
                order = self._epoch_order(epoch)
                pos = 0
            out.append(order[pos:pos + self.batch_size])
            pos += self.batch_size
        self._fp_pos, self._fp_order, self._fp_epoch = pos, order, epoch
        return np.stack(out).astype(np.int64)

    def sync_cursor(self, epoch: int, batches_served: int):
        """Put the ``take_indices`` cursor where a driver iterator stands
        after serving ``batches_served`` batches of ``epoch``."""
        self._fp_epoch = int(epoch)
        self._fp_order = self._epoch_order(int(epoch))
        self._fp_pos = int(batches_served) * self.batch_size

    def cursor_position(self):
        """``(epoch, batches_served)`` of the ``take_indices`` cursor."""
        pos = getattr(self, "_fp_pos", 0)
        epoch = getattr(self, "_fp_epoch", self.epoch)
        return int(epoch), int(pos // self.batch_size)

    def iter_from(self, epoch: int, batches_served: int):
        """Iterator over ``epoch`` from its batch ``batches_served`` on."""
        order = self._epoch_order(int(epoch))
        if self.device is not None:
            order = torch.as_tensor(order).to(self.device)
        end = self.n - self.batch_size + 1 if self.drop_last else self.n
        for i in range(int(batches_served) * self.batch_size, end, self.batch_size):
            yield self.postprocess(self.gather(order[i:i + self.batch_size]))


def shard_loader(loader: ArrayLoader, process_index=None, process_count=None) -> ArrayLoader:
    """Per-rank example sharding: rank i keeps examples ``i::N`` of every
    array (the reference's rank-round-robin ``DistributedBatchSampler``).
    A shallow copy, so that ``ArrayLoader`` subclasses (a custom
    ``postprocess``, their own attributes) survive; the epoch and the
    ``take_indices`` cursor start again. Defaults: the process group's rank
    and size (one process without a group)."""
    import copy

    if process_index is None or process_count is None:
        import torch.distributed as dist

        grouped = dist.is_initialized()
        process_index = dist.get_rank() if grouped else 0
        process_count = dist.get_world_size() if grouped else 1
    new = copy.copy(loader)
    new.arrays = tuple(a[process_index::process_count] for a in loader.arrays)
    new.n = len(new.arrays[0])
    new.epoch = 0
    for attr in ("_fp_pos", "_fp_order", "_fp_epoch"):
        if hasattr(new, attr):
            delattr(new, attr)
    return new


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Keep ``size`` batches of ``iterator`` in flight to ``device`` (default
    ``"cuda"``), so that the copies overlap the consumer's work; batches are
    yielded in order, the last ones included.

    On a CUDA device each tensor or numpy leaf of a batch is copied from
    pinned host memory with ``non_blocking=True`` on a side stream; the
    consumer's current stream waits on an event recorded after the batch's
    copies, and ``record_stream`` keeps the batch's memory from being reused
    while that stream may still read it. On the CPU the batches are yielded
    unchanged."""
    device = require_device("cuda" if device is None else device, "prefetch_to_device")
    if size < 1:
        raise ValueError(f"prefetch_to_device: size must be at least 1, got {size}")
    if device.type == "cuda":
        put, take = _cuda_transfer(device)
    else:
        put = take = _unchanged
    return _prefetch(iter(iterator), size, put, take)


def _unchanged(batch):
    return batch


def _prefetch(it, size, put, take):
    """``size`` batches of ``it`` started with ``put``, each handed out
    through ``take`` as the next one starts."""
    queue = collections.deque(put(batch) for batch in itertools.islice(it, size))
    while queue:
        yield take(queue.popleft())
        for batch in itertools.islice(it, 1):
            queue.append(put(batch))


def _pinned(x):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if x.device.type == "cpu" and not x.is_pinned():
        x = x.pin_memory()
    return x


def _cuda_transfer(device):
    """``(put, take)``: ``put`` copies a batch on a side stream and records
    an event after it; ``take`` makes the current stream wait on it."""
    stream = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(stream):
            out = tree_map(lambda x: _pinned(x).to(device, non_blocking=True)
                           if isinstance(x, (np.ndarray, torch.Tensor)) else x, batch)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def take(pending):
        batch, event = pending
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        for x in tree_leaves(batch):
            if isinstance(x, torch.Tensor):
                x.record_stream(consumer)
        return batch

    return put, take
