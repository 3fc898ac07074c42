"""Device-side augmentation: the port's ``data/augment.py`` against
``betty_tpu/data/augment.py``.

* ``random_resized_crop`` at 40 -> 32 with JAX's draws injected: boxes
  clamped at 8 pixels (upsampled) and boxes larger than the output (the
  antialias filter), float64 within 1e-10 and float32 within 1e-5
  (relative to max(1, max|JAX|), as every comparison here).
* The flip (JAX's Bernoulli draws), ``normalize``, ``center_crop_resize``
  (its box and matrices float32 under x64, as JAX's: equal to JAX's within
  1e-10 in float64, where float64 matrices would differ by 1e-7) and both
  ImageNet transforms.
* The port's own draws: shapes, finite values in the input's range, the
  same crops from the same seed, other crops from another; a full-area crop
  is a resize (``tests/test_data.py``'s case).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu.data import augment as J
from betty_tpu_torch.data import augment as T
from betty_tpu_torch.utils import seeded_generator
from torch_darts_common import one_thread

TOL = {np.float32: 1e-5, np.float64: 1e-10}
DTYPES = [np.float32, np.float64]

one_thread = pytest.fixture(autouse=True)(one_thread)


def _draws(key, batch, scale=(0.08, 1.0)):
    """JAX's draws of ``imagenet_train_transform(images, key)``: the crop's
    keys split as ``random_resized_crop`` splits them, then the flip's."""
    k_crop, k_flip = jax.random.split(key)
    k_area, k_ratio, k_y, k_x = jax.random.split(k_crop, 4)
    draws = {"area": jax.random.uniform(k_area, (batch,), minval=scale[0], maxval=scale[1]),
             "log_ratio": jax.random.uniform(k_ratio, (batch,), minval=math.log(3 / 4),
                                             maxval=math.log(4 / 3)),
             "y": jax.random.uniform(k_y, (batch,)), "x": jax.random.uniform(k_x, (batch,)),
             "flip": jax.random.bernoulli(k_flip, 0.5, (batch,))}
    return k_crop, {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def _images(dtype, shape=(16, 40, 40, 3), seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(dtype)


def _err(got, want):
    """Largest |difference|, relative to max(1, max|want|)."""
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("scale", [(0.08, 1.0), (0.001, 0.02)], ids=["default", "clamped"])
def test_random_resized_crop_matches_jax(dtype, scale):
    x = _images(dtype)
    with jax.enable_x64(dtype == np.float64):
        k_crop, draws = _draws(jax.random.PRNGKey(3), len(x), scale)
        want = J.random_resized_crop(jnp.asarray(x), k_crop, 32, scale=scale)
    side = torch.sqrt(draws["area"] * 40 * 40 / torch.exp(draws["log_ratio"]))
    if scale[1] < 0.1:
        assert bool((side < 8).all())  # every box clamped to 8 pixels, then upsampled
    else:
        assert bool((side > 32).any()) and bool((side < 32).any())  # antialiased and not
    got = T.random_resized_crop(torch.tensor(x), None, 32, scale=scale, draws=draws)
    assert got.shape == (16, 32, 32, 3) and got.dtype == torch.from_numpy(x).dtype
    assert _err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_flip_and_normalize_match_jax(dtype):
    x = _images(dtype, (64, 8, 8, 3))
    with jax.enable_x64(dtype == np.float64):
        key = jax.random.PRNGKey(0)
        flip = jax.random.bernoulli(key, 0.5, (64,))
        want = J.random_horizontal_flip(jnp.asarray(x), key)
        want_norm = J.normalize(jnp.asarray(x))
    got = T.random_horizontal_flip(torch.tensor(x), None, draws=torch.tensor(np.asarray(flip)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(np.asarray(flip).sum()) < 64
    assert _err(T.normalize(torch.tensor(x)), want_norm) <= TOL[dtype]


@pytest.mark.parametrize("shape", [(4, 40, 40, 3), (2, 100, 80, 1)], ids=["square", "100x80"])
def test_center_crop_resize_float32_matrices_under_x64(shape):
    x = _images(np.float64, shape)
    with jax.enable_x64(True):
        want = J.center_crop_resize(jnp.asarray(x), 32)
    got = T.center_crop_resize(torch.tensor(x), 32)
    assert got.dtype == torch.float64 and got.shape == (shape[0], 32, 32, shape[3])
    assert _err(got, want) <= TOL[np.float64]
    # the same box in float64 gives other matrices: the float32 ones are held
    H, W = shape[1:3]
    zoom = round(32 * 256 / 224) / min(H, W)
    box = torch.tensor([(H - 32 / zoom) / 2, (W - 32 / zoom) / 2, 32 / zoom, 32 / zoom],
                       dtype=torch.float64)
    f64 = T._resample(torch.tensor(x), box.expand(shape[0], 4), (32, 32))
    assert _err(f64, want) > 1e-9


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_transforms_match_jax(dtype):
    x = _images(dtype)
    with jax.enable_x64(dtype == np.float64):
        key = jax.random.PRNGKey(7)
        _, draws = _draws(key, len(x))
        want_train = J.imagenet_train_transform(jnp.asarray(x), key, out_size=32)
        want_eval = J.imagenet_eval_transform(jnp.asarray(x), out_size=32)
    got = T.imagenet_train_transform(torch.tensor(x), None, out_size=32, draws=draws)
    assert _err(got, want_train) <= TOL[dtype]
    assert _err(T.imagenet_eval_transform(torch.tensor(x), out_size=32), want_eval) <= TOL[dtype]


def test_own_draws_are_seeded():
    x = torch.tensor(_images(np.float32, (4, 64, 48, 3)))
    out = T.random_resized_crop(x, seeded_generator(5, "cpu"), 32)
    assert out.shape == (4, 32, 32, 3) and bool(torch.isfinite(out).all())
    assert float(out.min()) >= -1e-3 and float(out.max()) <= 1 + 1e-3
    again = T.random_resized_crop(x, seeded_generator(5, "cpu"), 32)
    other = T.random_resized_crop(x, seeded_generator(6, "cpu"), 32)
    assert torch.equal(out, again)
    assert float((out - other).abs().max()) > 1e-3
    train = T.imagenet_train_transform(x, seeded_generator(5, "cpu"), out_size=32)
    assert torch.equal(train, T.imagenet_train_transform(x, seeded_generator(5, "cpu"),
                                                         out_size=32))


def test_full_area_crop_is_resize():
    x = _images(np.float32, (2, 40, 40, 3), seed=1)
    out = T.random_resized_crop(torch.tensor(x), seeded_generator(0, "cpu"), 20,
                                scale=(1.0, 1.0), ratio=(1.0, 1.0))
    ref = jax.vmap(lambda im: jax.image.resize(im, (20, 20, 3), method="linear"))(
        jnp.asarray(x))
    assert _err(out, ref) < 1e-5


def test_only_linear_resampling():
    x = torch.zeros(1, 8, 8, 1)
    with pytest.raises(ValueError, match="linear"):
        T.center_crop_resize(x, 4, method="cubic")
