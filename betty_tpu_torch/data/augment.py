"""Image augmentation on the device, inside the training step
(``betty_tpu/data/augment.py``).

The ImageNet pipelines of the reference's torchvision input
(RandomResizedCrop + RandomHorizontalFlip + Normalize for training,
Resize + CenterCrop + Normalize for evaluation) as batched tensor ops on
NHWC images, so they run where the step runs and a compiled block captures
them with it.

A crop is a per-image affine resample: a box ``(y0, x0, h, w)`` in input
pixels maps onto the fixed output size. The JAX package does it with
``jax.image.scale_and_translate(method="linear", antialias=True)``, which
builds one weight matrix per image and axis (``compute_weight_mat``) and
contracts them with the image. ``_resample`` builds the same matrices: the
sample positions ``(arange(out) + 0.5) / scale - translation / scale -
0.5``, a triangle kernel ``max(0, 1 - |x|)`` widened by ``max(1 / scale,
1)`` (the antialias filter of a downsample), each output column divided by
its sum (or zeroed where the sum is at most ``1000 * eps(float32)``), and
columns whose sample lies outside ``[-0.5, in - 0.5]`` zeroed. They are
computed in the dtype of the box and cast to the image's, then applied as
two batched products. The column sums add in the order XLA's CPU backend
adds them (``_xla_order_sum``: sequential up to 32 terms; beyond, windows of
32 with the padding centred, each summed in order, then the window sums the
same way), as explicit elementwise adds, so that a float32 matrix rounds
as JAX's does, on the CPU and the card alike. (``F.interpolate`` and
``F.grid_sample`` take no per-image box with this kernel.) The eval box is float32, as JAX's
``jnp.asarray(..., jnp.float32)`` makes it, so its matrices are float32
whatever the image's dtype.

Random draws come from the ``torch.Generator`` passed in: a problem passes
``utils.seeded_generator(self.rng, device)``, so a step's re-evaluations
(darts' perturbed losses) draw the same crops and a compiled block reseeds
the generator before every replay. ``draws=`` replaces the draws (tests
inject the JAX package's): a dict of per-image tensors ``area`` (the crop's
area fraction), ``log_ratio`` (its log aspect ratio), ``y`` and ``x`` (the
box's position, uniform in [0, 1)) and, for the flip, ``flip`` (bool).
Under a data-parallel mesh each rank draws the global batch's values and
keeps its rows (``parallel.local_rows``).

As in the JAX package, one box is drawn and clamped to ``[8, H]`` x ``[8,
W]`` (torchvision rejection-samples up to 10 boxes and falls back to a
center crop).
"""

import math

import torch

from betty_tpu_torch.parallel import local_rows

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# the threshold under which compute_weight_mat zeroes a column's weights
_MIN_WEIGHT_SUM = 1000.0 * float(torch.finfo(torch.float32).eps)


def _constant(values, dtype, device):
    """A 1-d tensor of ``values`` made by fills on ``device`` (no copy from
    the host, which a CUDA graph cannot capture)."""
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device) for v in values])


def normalize(images, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """Channel-wise standardization of (..., C) images (torchvision
    ``Normalize``); ``mean`` and ``std`` in the images' dtype."""
    mean = _constant(mean, images.dtype, images.device)
    std = _constant(std, images.dtype, images.device)
    return (images - mean) / std


def random_horizontal_flip(images, generator, p=0.5, draws=None):
    """Each (B, H, W, C) image reversed along W with probability ``p``;
    ``draws`` is the (B,) bool flip of each image."""
    if draws is None:
        draws = local_rows((images.shape[0],), lambda s: torch.rand(
            s, generator=generator, device=images.device)) < p
    return torch.where(draws[:, None, None, None], images.flip(2), images)


def _xla_order_sum(x):
    """``x.sum(dim=1, keepdim=True)`` for ``x`` of shape (B, n, m), the terms
    added in XLA's order on the CPU: one after another where n <= 32; else
    ``ceil(n / 32)`` windows of 32 over ``x`` padded with zeros (the smaller
    half before), each window summed in order, then the window sums the
    same way."""
    B, n, m = x.shape
    if n <= 32:
        total = x[:, 0]
        for i in range(1, n):
            total = total + x[:, i]
        return total[:, None]
    windows = -(-n // 32)
    pad = windows * 32 - n
    x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2))
    x = x.reshape(B, windows, 32, m)
    partial = x[:, :, 0]
    for i in range(1, 32):
        partial = partial + x[:, :, i]
    return _xla_order_sum(partial)


def _weight_mats(in_size, out_size, scale, translation):
    """``compute_weight_mat`` for a batch: ``(B, in_size, out_size)`` linear
    resampling weights with antialias, in the dtype of ``scale`` (B,)."""
    dtype = scale.dtype
    inv_scale = (1.0 / scale)[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)[:, None]
    sample_f = ((torch.arange(out_size, dtype=dtype, device=scale.device) + 0.5) * inv_scale
                - translation[:, None] * inv_scale - 0.5)
    pixels = torch.arange(in_size, dtype=dtype, device=scale.device)[None, :, None]
    x = torch.abs(sample_f[:, None, :] - pixels) / kernel_scale
    weights = torch.clamp(1 - torch.abs(x), min=0)
    total = _xla_order_sum(weights)
    weights = torch.where(torch.abs(total) > _MIN_WEIGHT_SUM,
                          weights / torch.where(total != 0, total, torch.ones_like(total)), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0)


def _resample(images, boxes, out_hw):
    """Map each image's box ``(y0, x0, h, w)`` (rows of ``boxes``, in input
    pixels) onto ``out_hw``: ``scale_and_translate`` with ``scale = out /
    size`` and ``translation = -origin * out / size`` on each axis."""
    (oh, ow), (_, H, W, _) = out_hw, images.shape
    y0, x0, h, w = boxes.unbind(1)
    wy = _weight_mats(H, oh, oh / h, -y0 * oh / h).to(images.dtype)
    wx = _weight_mats(W, ow, ow / w, -x0 * ow / w).to(images.dtype)
    rows = torch.einsum("bhwc,bho->bowc", images, wy)
    return torch.einsum("bowc,bwp->bopc", rows, wx)


def _size(out_size):
    return (out_size, out_size) if isinstance(out_size, int) else tuple(out_size)


def random_resized_crop(images, generator, out_size, scale=(0.08, 1.0),
                        ratio=(3.0 / 4.0, 4.0 / 3.0), method="linear", draws=None):
    """Batched RandomResizedCrop of (B, H, W, C) float images to ``out_size``
    (an int or ``(out_h, out_w)``): the area fraction uniform in ``scale``,
    the log aspect ratio uniform in ``log(ratio)``, one clamped box an
    image. Draws in the images' dtype (at least float32)."""
    if method != "linear":
        raise ValueError(f"method {method!r}: only 'linear' (the JAX package's default)")
    B, H, W, _ = images.shape
    if draws is None:
        dtype = torch.promote_types(images.dtype, torch.float32)
        u = local_rows((4, B), lambda s: torch.rand(s, generator=generator,
                                                    device=images.device, dtype=dtype), dim=1)
        lo, hi = math.log(ratio[0]), math.log(ratio[1])
        draws = {"area": torch.clamp(u[0] * (scale[1] - scale[0]) + scale[0], min=scale[0]),
                 "log_ratio": torch.clamp(u[1] * (hi - lo) + lo, min=lo), "y": u[2], "x": u[3]}
    area, r = draws["area"], torch.exp(draws["log_ratio"])
    h = torch.clamp(torch.sqrt(area * H * W / r), 8.0, H)
    w = torch.clamp(torch.sqrt(area * H * W * r), 8.0, W)
    boxes = torch.stack([draws["y"] * (H - h), draws["x"] * (W - w), h, w], dim=1)
    return _resample(images, boxes, _size(out_size))


def center_crop_resize(images, out_size, resize_size=None, method="linear"):
    """Resize (the shorter side to ``resize_size``, by default ``out * 256 /
    224`` rounded) then CenterCrop, as one resample of a float32 box."""
    if method != "linear":
        raise ValueError(f"method {method!r}: only 'linear' (the JAX package's default)")
    B, H, W, _ = images.shape
    oh, ow = _size(out_size)
    if resize_size is None:
        resize_size = int(round(oh * 256 / 224))
    zoom = resize_size / min(H, W)
    h, w = oh / zoom, ow / zoom
    box = _constant([(H - h) / 2.0, (W - w) / 2.0, h, w], torch.float32, images.device)
    return _resample(images, box.expand(B, 4), (oh, ow))


def imagenet_train_transform(images, generator, out_size=224, mean=IMAGENET_MEAN,
                             std=IMAGENET_STD, draws=None):
    """RandomResizedCrop -> RandomHorizontalFlip -> Normalize; ``draws`` holds
    the crop's and the flip's."""
    x = random_resized_crop(images, generator, out_size, draws=draws)
    x = random_horizontal_flip(x, generator, draws=None if draws is None else draws["flip"])
    return normalize(x, mean, std)


def imagenet_eval_transform(images, out_size=224, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """Resize -> CenterCrop -> Normalize."""
    return normalize(center_crop_resize(images, out_size), mean, std)
