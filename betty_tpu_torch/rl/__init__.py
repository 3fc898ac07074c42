from betty_tpu_torch.rl.buffer import ExperienceBuffer

__all__ = ["ExperienceBuffer"]
