from betty_tpu_torch.envs.env_base import Env

__all__ = ["Env"]
