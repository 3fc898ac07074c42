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
"""

import numpy as np
import torch


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
