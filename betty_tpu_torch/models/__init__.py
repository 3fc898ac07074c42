from betty_tpu_torch.models.mlp import MetaWeightNet
from betty_tpu_torch.models.transformer import TransformerClassifier, roberta_large_config

__all__ = ["MetaWeightNet", "TransformerClassifier", "roberta_large_config"]
