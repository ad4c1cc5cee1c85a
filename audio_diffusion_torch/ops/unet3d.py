"""3-D U-Net (video, volumes): the ``dim=3`` path of ``UNetV0``
(counterpart of audio_diffusion_tpu/ops/unet3d.py). The body is shared
with the other rank in ``ops/unet_nd.py``."""
from __future__ import annotations

from .unet_nd import XUNetNd

__all__ = ["XUNet3d"]


class XUNet3d(XUNetNd):
    """3-D analog of ``XUNet`` (same level structure, conditioning and
    encoder reuse). I/O [B, C, D, H, W]; ``channels=`` context tensors
    [B, ctx, *spatial_i]."""

    def __init__(self, *args, **kwargs):
        super().__init__(3, *args, **kwargs)
