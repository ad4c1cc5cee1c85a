"""The training data pipeline (counterpart of audio_diffusion_tpu/data):
the native WAV decoder, the host ``AudioDataset`` and the device-resident
``DeviceCorpus``."""
from .device import DeviceCorpus
from .loader import (AudioDataset, wav_probe, wav_probe_ex, wav_read,
                     wav_write)

__all__ = ["AudioDataset", "DeviceCorpus", "wav_probe", "wav_probe_ex",
           "wav_read", "wav_write"]
