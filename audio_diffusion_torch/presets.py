"""Ready-made model configurations (own copy of the dicts in
audio_diffusion_tpu/presets.py)::

    from audio_diffusion_torch import DiffusionModel, UNetV0, presets

    model = DiffusionModel(net_t=UNetV0, **presets.UNCONDITIONAL_48K)

    model = DiffusionModel(net_t=UNetV0, text_encoder=RandomT5TextEncoder(),
                           **presets.TEXT_CONDITIONAL_48K)
    model.sample(noise, text=["rain on a roof"], embedding_scale=5.0,
                 num_steps=50)

    ar = DiffusionAR(net_t=UNetV0, in_channels=1, length=2**16,
                     num_splits=4, **presets._NET_9LEVEL)

    up = DiffusionUpsampler(net_t=UNetV0, upsample_factor=16,
                            **presets.UPSAMPLER_16X)

    voc = DiffusionVocoder(net_t=UNetV0, **presets.VOCODER_48K)

    ae = DiffusionAE(net_t=UNetV0, inject_depth=6,
                     encoder=MelEncoder1d(in_channels=2, channels=512,
                                          factors=[2], num_blocks=[12],
                                          out_channels=32, mel_channels=80),
                     **presets.AUTOENCODER_48K)

Every preset runs in the port. ``UNCONDITIONAL_48K`` and
``TEXT_CONDITIONAL_48K`` build a ``DiffusionModel``, ``_NET_9LEVEL`` a
``DiffusionAR``, ``UPSAMPLER_16X`` a ``DiffusionUpsampler``,
``VOCODER_48K`` a ``DiffusionVocoder`` (its ``mel_*`` keys configure the
mel front end) and ``AUTOENCODER_48K`` a ``DiffusionAE``, which also takes
an encoder and an ``inject_depth`` (the JAX CLI's encoder, above, has a
downsampling factor of 512, which depth 6 of the 9-level net matches). The
text-conditional one needs a ``text_encoder``: ``ops.text.RandomT5TextEncoder``
(the T5 encoder stack with random weights) or ``ops.text.StubTextEncoder``
(the pretrained ``T5TextEncoder`` waits for its weights), or ``embedding=``
passed directly.
"""
from __future__ import annotations

# The 9-level U-Net geometry shared by every reference README config:
# ×4096 total downsampling of 2^18-sample (≈5.5 s at 48 kHz) audio.
_NET_9LEVEL = dict(
    channels=[8, 32, 64, 128, 256, 512, 512, 1024, 1024],
    factors=[1, 4, 4, 4, 2, 2, 2, 2, 2],
    items=[1, 2, 2, 2, 2, 2, 2, 4, 4],
)

# Unconditional audio generation: self-attention at the 4 coarse levels.
UNCONDITIONAL_48K = dict(
    in_channels=2,
    **_NET_9LEVEL,
    attentions=[0, 0, 0, 0, 0, 1, 1, 1, 1],
    attention_heads=8,
    attention_features=64,
)

# Text-conditional generation with T5 embeddings + classifier-free guidance.
TEXT_CONDITIONAL_48K = dict(
    **UNCONDITIONAL_48K,
    cross_attentions=[0, 0, 0, 1, 1, 1, 1, 1, 1],
    use_text_conditioning=True,
    use_embedding_cfg=True,
    embedding_max_length=64,
    embedding_features=768,
)

# ×16 upsampler (DiffusionUpsampler).
UPSAMPLER_16X = dict(in_channels=2, **_NET_9LEVEL)

# Mel-spectrogram vocoder (DiffusionVocoder).
VOCODER_48K = dict(
    mel_n_fft=1024,
    mel_channels=80,
    mel_sample_rate=48000,
    mel_normalize_log=True,
    **_NET_9LEVEL,
)

# Diffusion autoencoder with latent injection at depth 6 (DiffusionAE).
AUTOENCODER_48K = dict(in_channels=2, **_NET_9LEVEL)

__all__ = [
    "UNCONDITIONAL_48K",
    "TEXT_CONDITIONAL_48K",
    "UPSAMPLER_16X",
    "VOCODER_48K",
    "AUTOENCODER_48K",
]
