from .encoders import MelEncoder1d, TanhBottleneck
from .model import AdapterBase, DiffusionModel, EncoderBase
from .tasks import DiffusionAE, DiffusionAR, DiffusionUpsampler, DiffusionVocoder

__all__ = ["DiffusionModel", "EncoderBase", "AdapterBase", "DiffusionAE",
           "DiffusionUpsampler", "DiffusionVocoder", "DiffusionAR",
           "MelEncoder1d", "TanhBottleneck"]
