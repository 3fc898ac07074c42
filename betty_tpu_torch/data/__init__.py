from betty_tpu_torch.data.augment import (IMAGENET_MEAN, IMAGENET_STD, center_crop_resize,
                                          imagenet_eval_transform, imagenet_train_transform,
                                          normalize, random_horizontal_flip, random_resized_crop)
from betty_tpu_torch.data.loader import ArrayLoader, prefetch_to_device, shard_loader

__all__ = ["ArrayLoader", "IMAGENET_MEAN", "IMAGENET_STD", "center_crop_resize",
           "imagenet_eval_transform", "imagenet_train_transform", "normalize",
           "prefetch_to_device", "random_horizontal_flip", "random_resized_crop", "shard_loader"]
