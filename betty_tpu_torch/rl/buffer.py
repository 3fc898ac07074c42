"""Experience buffer for RL workloads (``betty_tpu/rl/buffer.py``, the same
numpy code): rollouts accumulate on the host as numpy arrays, ``stacked()``
stacks each field over the steps added, and ``batches()`` yields
minibatches for the problems to move to the device."""

from typing import Dict, Iterator, List

import numpy as np


class ExperienceBuffer:
    def __init__(self):
        self._data: Dict[str, List[np.ndarray]] = {}
        self._epoch = 0  # the default shuffle stream of batches()

    def add(self, **fields):
        for key, value in fields.items():
            self._data.setdefault(key, []).append(np.asarray(value))

    def __len__(self):
        if not self._data:
            return 0
        return len(next(iter(self._data.values())))

    def stacked(self) -> Dict[str, np.ndarray]:
        return {k: np.stack(v) for k, v in self._data.items()}

    def clear(self):
        self._data = {}
        self._epoch = 0

    def batches(self, batch_size: int, shuffle=True, seed=None,
                drop_last=True) -> Iterator[Dict[str, np.ndarray]]:
        """``seed=None`` (the default) shuffles with the buffer's epoch
        counter, which advances every call, so repeated epochs over the same
        buffer see different orders; a seed gives a reproducible order."""
        data = self.stacked()
        n = len(self)
        order = np.arange(n)
        if shuffle:
            if seed is None:
                seed = self._epoch
                self._epoch += 1
            np.random.RandomState(seed).shuffle(order)
        end = n - batch_size + 1 if drop_last else n
        for i in range(0, end, batch_size):
            idx = order[i:i + batch_size]
            yield {k: v[idx] for k, v in data.items()}
