from betty_tpu_torch.misc.early_stopping import EarlyStopping

__all__ = ["EarlyStopping"]
