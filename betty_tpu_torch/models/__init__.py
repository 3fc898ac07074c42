from betty_tpu_torch.models.mlp import MetaWeightNet
from betty_tpu_torch.models.resnet import BasicBlock, ResNet, ResNet32
from betty_tpu_torch.models.transformer import TransformerClassifier, roberta_large_config

__all__ = ["BasicBlock", "MetaWeightNet", "ResNet", "ResNet32", "TransformerClassifier",
           "roberta_large_config"]
