from .core import alpha_beta, clip, extend_dim, pad_dims
from .distributions import Distribution, UniformDistribution
from .inpainter import Inpainter, VInpainter
from .samplers import (ARVSampler, DPMSampler, Sampler, SDESampler,
                       VSampler)
from .schedules import LinearSchedule, Schedule, UniformLambdaSchedule
from .vdiffusion import (ARVDiffusion, Diffusion, VDiffusion, arv_loss,
                         mse_loss, v_loss)

__all__ = [
    "alpha_beta",
    "clip",
    "extend_dim",
    "pad_dims",
    "Distribution",
    "UniformDistribution",
    "Diffusion",
    "VDiffusion",
    "ARVDiffusion",
    "mse_loss",
    "v_loss",
    "arv_loss",
    "Sampler",
    "VSampler",
    "SDESampler",
    "DPMSampler",
    "ARVSampler",
    "Inpainter",
    "VInpainter",
    "Schedule",
    "LinearSchedule",
    "UniformLambdaSchedule",
]
