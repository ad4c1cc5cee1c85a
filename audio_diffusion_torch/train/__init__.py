"""The training loop (counterpart of audio_diffusion_tpu/train)."""
from .trainer import ClipAdamW, Trainer, TrainerConfig, lr_schedule

__all__ = ["Trainer", "TrainerConfig", "ClipAdamW", "lr_schedule"]
