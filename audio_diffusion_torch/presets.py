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

``UNCONDITIONAL_48K`` and ``TEXT_CONDITIONAL_48K`` run in the port, and so
does ``_NET_9LEVEL`` under ``DiffusionAR``. The text-conditional one needs
a ``text_encoder``: ``ops.text.RandomT5TextEncoder`` (the T5 encoder stack
with random weights) or ``ops.text.StubTextEncoder`` (the pretrained
``T5TextEncoder`` waits for its weights), or ``embedding=`` passed
directly. The others need task models that are not ported yet.
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
