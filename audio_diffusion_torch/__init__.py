"""audio_diffusion_torch — the PyTorch/CUDA port of audio_diffusion_tpu for
NVIDIA Hopper (H100). Ported so far: the unconditional sampling path
(``DiffusionModel`` + ``UNetV0`` at dim=1 + ``VSampler``) and the one-device
training path (``VDiffusion`` loss, ``make_train_step``), with the fused
resnet item's forward and backward as hand-written CUDA kernels, and
``params_from_jax`` to carry weights across from the JAX package.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
from . import presets
from .convert import params_from_jax
from .diffusion import (Diffusion, Distribution, LinearSchedule, Sampler,
                        Schedule, UniformDistribution, UniformLambdaSchedule,
                        VDiffusion, VSampler, mse_loss)
from .models import DiffusionModel
from .ops import Net, UNetV0, XUNet, cast_inference_params
from .parallel import TrainState, make_train_step

__version__ = "0.1.0"

__all__ = [
    "presets",
    "params_from_jax",
    "DiffusionModel",
    "Net",
    "UNetV0",
    "XUNet",
    "cast_inference_params",
    "Diffusion",
    "VDiffusion",
    "mse_loss",
    "Distribution",
    "UniformDistribution",
    "TrainState",
    "make_train_step",
    "Sampler",
    "VSampler",
    "Schedule",
    "LinearSchedule",
    "UniformLambdaSchedule",
]
