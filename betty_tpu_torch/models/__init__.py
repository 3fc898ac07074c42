from betty_tpu_torch.models.darts import (DARTS_V2, DARTSEvalNetwork, DARTSNetwork, Genotype,
                                          derive_genotype, genotype_from_json, genotype_to_json,
                                          init_alphas)
from betty_tpu_torch.models.mlp import MetaWeightNet
from betty_tpu_torch.models.resnet import BasicBlock, ResNet, ResNet32
from betty_tpu_torch.models.transformer import TransformerClassifier, roberta_large_config

__all__ = ["BasicBlock", "DARTSEvalNetwork", "DARTSNetwork", "DARTS_V2", "Genotype",
           "MetaWeightNet", "ResNet", "ResNet32", "TransformerClassifier", "derive_genotype",
           "genotype_from_json", "genotype_to_json", "init_alphas", "roberta_large_config"]
