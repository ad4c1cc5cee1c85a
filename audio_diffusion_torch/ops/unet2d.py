"""2-D U-Net (images, spectrograms): the ``dim=2`` path of ``UNetV0``
(counterpart of audio_diffusion_tpu/ops/unet2d.py). The body is shared
with the other rank in ``ops/unet_nd.py``."""
from __future__ import annotations

from .unet_nd import XUNetNd

__all__ = ["XUNet2d"]


class XUNet2d(XUNetNd):
    """2-D analog of ``XUNet`` (same level structure, conditioning and
    encoder reuse). I/O [B, C, H, W]; ``channels=`` context tensors
    [B, ctx, *spatial_i]."""

    def __init__(self, *args, **kwargs):
        super().__init__(2, *args, **kwargs)
