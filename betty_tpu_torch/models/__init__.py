from betty_tpu_torch.models.darts import (DARTS_V2, DARTSEvalNetwork, DARTSNetwork, Genotype,
                                          derive_genotype, genotype_from_json, genotype_to_json,
                                          init_alphas)
from betty_tpu_torch.models.iuc import Captioner, DecoderBlock
from betty_tpu_torch.models.mlp import MLP, MetaWeightNet
from betty_tpu_torch.models.moe import (MOE_COMPOSED_SHARD_RULES, init_moe_params, moe_ffn,
                                       moe_ffn_dense)
from betty_tpu_torch.models.omniglot import OmniglotCNN
from betty_tpu_torch.models.resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet32,
                                          ResNet50, ResNetV1, WideResNet)
from betty_tpu_torch.models.transformer import (COMPOSED_SHARD_RULES, SP_COMPOSED_SHARD_RULES,
                                                TransformerClassifier,
                                                make_pipelined_transformer,
                                                pipelined_shard_rules, roberta_large_config)

__all__ = ["BasicBlock", "BottleneckBlock", "COMPOSED_SHARD_RULES", "Captioner", "DARTSEvalNetwork", "DARTSNetwork",
           "DARTS_V2", "DecoderBlock", "Genotype", "MLP", "MOE_COMPOSED_SHARD_RULES", "MetaWeightNet",
           "OmniglotCNN", "ResNet", "SP_COMPOSED_SHARD_RULES",
           "ResNet32", "ResNet50", "ResNetV1", "TransformerClassifier", "WideResNet",
           "derive_genotype", "genotype_from_json", "genotype_to_json", "init_alphas",
           "init_moe_params", "make_pipelined_transformer", "moe_ffn", "moe_ffn_dense",
           "pipelined_shard_rules", "roberta_large_config"]
