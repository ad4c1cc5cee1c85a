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
no-modulation branch; the T5 encoder stack behind
``ops.text.RandomT5TextEncoder``; and the DSP front end (``dsp``: sinc
resampling, STFT, Griffin-Lim, ``MelSpectrogram``), the multi-resolution
STFT loss, the net plugins ``LTPlugin`` and ``AppendChannelsPlugin`` and
the task models ``DiffusionUpsampler``, ``DiffusionVocoder`` and
``DiffusionAE`` (with ``MelEncoder1d``, whose items run the kernels'
no-modulation branch); the trainer (``train.Trainer``, with
checkpoint/resume, LR schedules, clipping, EMA), the data pipeline
(``data.AudioDataset``, ``data.DeviceCorpus``), activation checkpointing
(``UNetV0(use_remat=True)``), ``train_state_from_jax`` to carry a JAX train
state across, and the ``train``, ``sample`` and ``info`` commands of
``python -m audio_diffusion_torch``; and serving: the batching
``GenerationService``, the HTTP server (``make_server``, ``wav_bytes``),
int8/int4 weight-only quantization (``QTensor``, ``quantize_params``,
``dequantize_params``, ``unpack_int4_leaves``), the exported sampler
(``export_sampler``, ``load_sampler``, ``load_params``,
``ArtifactSampler``, with encoder reuse) and the ``serve`` and ``export``
commands; progressive and guidance distillation
(``ProgressiveDistiller``) with the ``distill`` command, and evaluation:
the band-profile metrics (``eval``), the corpus-trained embedder
(``CorpusEmbedder``, ``frechet_embedding_distance``) and the ``eval``
command; and multi-GPU (``parallel``): the ``("data", "model")`` mesh on
``torch.distributed`` (``create_mesh``, ``shard_batch``, ``global_batch``,
``param_sharding_rules``, ``shard_params``), the data-parallel, ZeRO-1 and
model-sharded train step, ``sample_length_sharded`` on a length-sharded
fused item, and ``mesh=`` through the ``Trainer``, ``DeviceCorpus``, the
distiller and the ``train`` and ``distill`` commands.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
from . import dsp, presets
from .convert import params_from_jax, params_to_jax, train_state_from_jax
from .diffusion import (ARVDiffusion, ARVSampler, Diffusion, Distribution,
                        DPMSampler, Inpainter, LinearSchedule, Sampler,
                        Schedule, SDESampler, UniformDistribution,
                        UniformLambdaSchedule, VDiffusion, VInpainter,
                        VSampler, mse_loss)
from .distill import ProgressiveDistiller
from .dsp import MelSpectrogram
from .embed import CorpusEmbedder, frechet_embedding_distance
from .export import ArtifactSampler, export_sampler, load_params, load_sampler
from .longform import generate_long
from .losses import MultiResolutionSTFTLoss, multi_resolution_stft_loss
from .models import (AdapterBase, DiffusionAE, DiffusionAR, DiffusionModel,
                     DiffusionUpsampler, DiffusionVocoder, EncoderBase,
                     MelEncoder1d, TanhBottleneck)
from .ops import (AppendChannelsPlugin, LTPlugin, Net, UNetV0, XUNet,
                  cast_inference_params)
from .ops.quant import (QTensor, dequantize_params, quantize_params,
                        unpack_int4_leaves)
from .parallel import (TrainState, create_mesh, global_batch, make_train_step,
                       param_sharding_rules, sample_length_sharded,
                       shard_batch, shard_params)
from .serve import GenerationService
from .server import make_server, wav_bytes

__version__ = "0.1.0"

__all__ = [
    "presets",
    "dsp",
    "params_from_jax",
    "params_to_jax",
    "train_state_from_jax",
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
    "create_mesh",
    "shard_batch",
    "global_batch",
    "shard_params",
    "param_sharding_rules",
    "sample_length_sharded",
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
    "LTPlugin",
    "AppendChannelsPlugin",
    "MelSpectrogram",
    "DiffusionAE",
    "DiffusionUpsampler",
    "DiffusionVocoder",
    "EncoderBase",
    "AdapterBase",
    "MelEncoder1d",
    "TanhBottleneck",
    "MultiResolutionSTFTLoss",
    "multi_resolution_stft_loss",
    "GenerationService",
    "make_server",
    "wav_bytes",
    "QTensor",
    "quantize_params",
    "dequantize_params",
    "unpack_int4_leaves",
    "export_sampler",
    "load_sampler",
    "load_params",
    "ArtifactSampler",
    "ProgressiveDistiller",
    "CorpusEmbedder",
    "frechet_embedding_distance",
]
