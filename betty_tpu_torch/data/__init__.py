from betty_tpu_torch.data.augment import (IMAGENET_MEAN, IMAGENET_STD, center_crop_resize,
                                          imagenet_eval_transform, imagenet_train_transform,
                                          normalize, random_horizontal_flip, random_resized_crop)
from betty_tpu_torch.data.loader import ArrayLoader

__all__ = ["ArrayLoader", "IMAGENET_MEAN", "IMAGENET_STD", "center_crop_resize",
           "imagenet_eval_transform", "imagenet_train_transform", "normalize",
           "random_horizontal_flip", "random_resized_crop"]
