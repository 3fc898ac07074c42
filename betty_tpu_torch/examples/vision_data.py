"""Dataset ingestion for the vision examples (the port's copy of
``examples/vision_data.py``'s numpy code).

No dataset is downloaded: the examples train on synthetic data by default
and read a local CIFAR-10/100 copy when given one, either the torchvision
pickle layout (``cifar-10-batches-py`` / ``cifar-100-python``) or an
``.npz`` with ``x_train/y_train/x_test/y_test``; Omniglot from an npz of
``images``/``labels``. Images are float32 NHWC.
"""

import os
import pickle

import numpy as np
import torch

CIFAR_MEAN = np.array([125.3, 123.0, 113.9], np.float32) / 255.0
CIFAR_STD = np.array([63.0, 62.1, 66.7], np.float32) / 255.0


def normalize_images(x, mean=CIFAR_MEAN, std=CIFAR_STD):
    x = np.asarray(x, np.float32)
    if x.max() > 2.0:  # uint8 range
        x = x / 255.0
    return (x - mean) / std


def _load_cifar_pickle_dir(path):
    def batch(name):
        with open(os.path.join(path, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.asarray(d.get(b"labels", d.get(b"fine_labels")), np.int32)
        return x, y

    if os.path.exists(os.path.join(path, "data_batch_1")):  # cifar10
        xs, ys = zip(*[batch(f"data_batch_{i}") for i in range(1, 6)])
        x_train, y_train = np.concatenate(xs), np.concatenate(ys)
        x_test, y_test = batch("test_batch")
    else:  # cifar100
        x_train, y_train = batch("train")
        x_test, y_test = batch("test")
    return x_train, y_train, x_test, y_test


def load_classification(data_dir, normalize=True):
    """(x_train, y_train, x_test, y_test) from an npz file or a CIFAR
    pickle directory; images float32 HWC (normalized when requested)."""
    if os.path.isfile(data_dir) and data_dir.endswith(".npz"):
        d = np.load(data_dir)
        x_train, y_train = d["x_train"], d["y_train"]
        x_test, y_test = d["x_test"], d["y_test"]
    else:
        for sub in ("cifar-10-batches-py", "cifar-100-python", ""):
            p = os.path.join(data_dir, sub) if sub else data_dir
            if os.path.exists(os.path.join(p, "data_batch_1")) or \
                    os.path.exists(os.path.join(p, "train")):
                x_train, y_train, x_test, y_test = _load_cifar_pickle_dir(p)
                break
        else:
            raise FileNotFoundError(f"no dataset found under {data_dir!r}")
    if normalize:
        x_train, x_test = normalize_images(x_train), normalize_images(x_test)
    else:
        x_train = np.asarray(x_train, np.float32)
        x_test = np.asarray(x_test, np.float32)
    return (x_train, np.asarray(y_train, np.int32),
            x_test, np.asarray(y_test, np.int32))


def load_omniglot(data_dir):
    """An Omniglot-style npz: ``(images (N, 28, 28, 1) float32 in [0, 1],
    labels (N,) int64 character ids)``; uint8 images are scaled by 1/255
    and (N, 28, 28) images get a channel axis."""
    d = np.load(data_dir)
    x = np.asarray(d["images"], np.float32)
    if x.max() > 2.0:
        x = x / 255.0
    if x.ndim == 3:
        x = x[..., None]
    return x, np.asarray(d["labels"], np.int64)


def problem_accuracy(problem, x, y, batch=256):
    """Accuracy (percent) of a problem's forward (``engine.<name>``) over
    ``(x, y)`` in batches on the problem's device; the trailing partial
    batch is padded to the batch size and counted too. Correct predictions
    are summed on the device and read once."""
    bs = min(batch, len(y))
    device = problem.device
    correct = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(0, len(y), bs):
        xb, yb = np.asarray(x[i:i + bs]), np.asarray(y[i:i + bs])
        k = len(yb)
        if k < bs:  # pad the tail to the steady batch shape
            xb = np.concatenate([xb, np.asarray(x[:bs - k])])
        logits = problem(torch.from_numpy(xb).to(device))
        pred = logits[:k].argmax(dim=1)
        correct += (pred == torch.from_numpy(yb).to(device)).sum()
    return 100.0 * int(correct) / max(len(y), 1)
