"""audio_diffusion_torch — the PyTorch/CUDA port of audio_diffusion_tpu for
NVIDIA Hopper (H100). Ported so far: the unconditional sampling path
(``DiffusionModel`` + ``UNetV0`` at dim=1 + ``VSampler``) and the one-device
training path (``VDiffusion`` loss, ``make_train_step``), with the fused
resnet item's forward and backward as hand-written CUDA kernels; the
text-conditional net (cross-attention, context injection, classifier-free
guidance, ``text=`` through ``ops.text.StubTextEncoder``) and encoder reuse
in ``VSampler``; ``params_from_jax`` / ``params_to_jax`` to carry
weights between the two packages; the other samplers (``DPMSampler``,
``SDESampler``), RePaint inpainting (``VInpainter``) and long-form
generation (``generate_long``); the autoregressive model (``DiffusionAR``
with ``ARVDiffusion`` and ``ARVSampler``), whose items run the kernels'
no-modulation branch; and the T5 encoder stack behind
``ops.text.RandomT5TextEncoder``.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
from . import presets
from .convert import params_from_jax, params_to_jax
from .diffusion import (ARVDiffusion, ARVSampler, Diffusion, Distribution,
                        DPMSampler, Inpainter, LinearSchedule, Sampler,
                        Schedule, SDESampler, UniformDistribution,
                        UniformLambdaSchedule, VDiffusion, VInpainter,
                        VSampler, mse_loss)
from .longform import generate_long
from .models import DiffusionAR, DiffusionModel
from .ops import Net, UNetV0, XUNet, cast_inference_params
from .parallel import TrainState, make_train_step

__version__ = "0.1.0"

__all__ = [
    "presets",
    "params_from_jax",
    "params_to_jax",
    "DiffusionModel",
    "DiffusionAR",
    "generate_long",
    "Net",
    "UNetV0",
    "XUNet",
    "cast_inference_params",
    "Diffusion",
    "VDiffusion",
    "ARVDiffusion",
    "mse_loss",
    "Distribution",
    "UniformDistribution",
    "TrainState",
    "make_train_step",
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
