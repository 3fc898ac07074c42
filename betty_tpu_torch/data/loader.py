"""Epoch-seeded minibatches over in-memory arrays
(``betty_tpu/data/loader.py::ArrayLoader``).

The shuffle of each epoch is ``np.random.RandomState(seed + epoch)
.permutation(n)``, the JAX loader's, so both packages serve the same
batches. With ``device`` set (``True`` for ``"cuda"``, or a device) the
arrays are moved to the device once and batches are gathered there.
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

    def __iter__(self):
        order = self._epoch_order(self.epoch)
        if self.device is not None:
            order = torch.as_tensor(order).to(self.device)
        end = self.n - self.batch_size + 1 if self.drop_last else self.n
        for i in range(0, end, self.batch_size):
            idx = order[i:i + self.batch_size]
            batch = tuple(a[idx] for a in self.arrays)
            yield batch[0] if len(batch) == 1 else batch
