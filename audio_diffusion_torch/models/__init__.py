from .model import DiffusionModel
from .tasks import DiffusionAR

__all__ = ["DiffusionModel", "DiffusionAR"]
