"""CIFAR-10 data for Meta-Weight-Net: balanced meta split, long-tail
imbalance, label corruption and train-time augmentation (the port's copy of
``examples/learning_to_reweight/mwn_data.py``).

The numpy ``RandomState`` streams are the JAX example's, draw for draw, so
both packages make the same splits, corruptions and crops:

* a balanced meta set of ``num_meta_total / num_classes`` images a class;
* long-tail imbalance: class c keeps ``sample_num / IF**(c/(C-1))``
  examples, the counts shuffled across classes;
* corruption matrices ``uniform`` / ``flip1`` / ``flip2`` applied row-wise
  to the training labels;
* augmentation: reflect-pad-4 random crop and horizontal flip of each
  train batch on the host.
"""

import numpy as np

from betty_tpu_torch.examples.vision_data import load_classification as load_cifar10  # noqa: F401


# --------------------------------------------------------------- corruption
def uniform_corruption(ratio, num_classes):
    eye = np.eye(num_classes)
    noise = np.full((num_classes, num_classes), 1 / num_classes)
    return eye * (1 - ratio) + noise * ratio


def flip1_corruption(ratio, num_classes, rng):
    m = np.eye(num_classes) * (1 - ratio)
    rows = np.arange(num_classes)
    for i in range(num_classes):
        m[i][rng.choice(rows[rows != i])] = ratio
    return m


def flip2_corruption(ratio, num_classes, rng):
    m = np.eye(num_classes) * (1 - ratio)
    rows = np.arange(num_classes)
    for i in range(num_classes):
        m[i][rng.choice(rows[rows != i], 2, replace=False)] = ratio / 2
    return m


def corrupt_labels(y, corruption_type, ratio, num_classes, rng):
    """(new labels, mask of the changed ones)."""
    if corruption_type is None or ratio <= 0:
        return y, np.zeros(len(y), bool)
    if corruption_type == "uniform":
        mat = uniform_corruption(ratio, num_classes)
    elif corruption_type == "flip1":
        mat = flip1_corruption(ratio, num_classes, rng)
    elif corruption_type == "flip2":
        mat = flip2_corruption(ratio, num_classes, rng)
    else:
        raise ValueError(f"unknown corruption type {corruption_type!r}")
    new_y = np.array([rng.choice(num_classes, p=mat[c]) for c in y], np.int32)
    return new_y, new_y != y


# ----------------------------------------------------------- split/imbalance
def build_splits(x, y, num_classes=10, num_meta_total=1000, imbalanced_factor=None,
                 corruption_type=None, corruption_ratio=0.0, seed=1, return_indices=False):
    """(x_train, y_train, x_meta, y_meta): balanced meta split, then
    optional long-tail imbalance and label corruption on the train part.
    With ``return_indices=True`` also ``idx_train``, the positions of the
    kept training examples in ``x`` (``--export_weights`` saves them for
    ``--retrain``)."""
    rng = np.random.RandomState(seed)
    num_meta = num_meta_total // num_classes

    if imbalanced_factor is not None:
        sample_num = (len(y) - num_meta_total) // num_classes
        counts = [int(sample_num / imbalanced_factor ** (c / (num_classes - 1)))
                  for c in range(num_classes)]
        rng.shuffle(counts)
    else:
        counts = None

    idx_meta, idx_train = [], []
    for c in range(num_classes):
        idx_c = np.flatnonzero(y == c)
        rng.shuffle(idx_c)
        idx_meta.extend(idx_c[:num_meta])
        keep = idx_c[num_meta:]
        if counts is not None:
            keep = keep[:counts[c]]
        idx_train.extend(keep)

    idx_meta = np.asarray(idx_meta)
    idx_train = np.asarray(idx_train)
    rng.shuffle(idx_train)

    y_train, _ = corrupt_labels(y[idx_train], corruption_type, corruption_ratio, num_classes,
                                rng)
    if return_indices:
        return x[idx_train], y_train, x[idx_meta], y[idx_meta], idx_train
    return x[idx_train], y_train, x[idx_meta], y[idx_meta]


# -------------------------------------------------------------- augmentation
def augment_batch(x, rng):
    """Reflect-pad-4 random crop + random horizontal flip (host numpy)."""
    n, h, w, _ = x.shape
    padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    out = np.empty_like(x)
    offs = rng.randint(0, 9, size=(n, 2))
    flips = rng.rand(n) < 0.5
    for i in range(n):
        dy, dx = offs[i]
        img = padded[i, dy:dy + h, dx:dx + w]
        out[i] = img[:, ::-1] if flips[i] else img
    return out
