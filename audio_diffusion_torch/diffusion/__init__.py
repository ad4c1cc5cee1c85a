from .core import alpha_beta, clip, extend_dim, pad_dims
from .distributions import Distribution, UniformDistribution
from .samplers import Sampler, VSampler
from .schedules import LinearSchedule, Schedule, UniformLambdaSchedule
from .vdiffusion import Diffusion, VDiffusion, mse_loss, v_loss

__all__ = [
    "alpha_beta",
    "clip",
    "extend_dim",
    "pad_dims",
    "Distribution",
    "UniformDistribution",
    "Diffusion",
    "VDiffusion",
    "mse_loss",
    "v_loss",
    "Sampler",
    "VSampler",
    "Schedule",
    "LinearSchedule",
    "UniformLambdaSchedule",
]
