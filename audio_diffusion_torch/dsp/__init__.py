from .mel import MelSpectrogram, griffin_lim, istft, melscale_fbanks, stft
from .resample import downsample, resample, upsample

__all__ = [
    "resample",
    "downsample",
    "upsample",
    "stft",
    "istft",
    "griffin_lim",
    "melscale_fbanks",
    "MelSpectrogram",
]
