from betty_tpu_torch.data.loader import ArrayLoader

__all__ = ["ArrayLoader"]
