"""Structured audio losses, usable as ``DiffusionModel(loss_fn=...)``
(counterpart of audio_diffusion_tpu/losses.py).

MultiResolutionSTFTLoss is the mean over resolutions of spectral
convergence plus log-magnitude L1 (Yamamoto et al. 2019, Parallel WaveGAN),
with auraloss's default resolutions, on the port's ``torch.fft`` STFT;
differentiable through the FFT.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import Tensor

from .dsp.mel import stft

__all__ = ["stft_magnitude", "multi_resolution_stft_loss",
           "MultiResolutionSTFTLoss"]


def stft_magnitude(x: Tensor, n_fft: int, hop_length: int,
                   win_length: int) -> Tensor:
    """|STFT| of [..., t], leading dims flattened (center=False, Hann)."""
    flat = x.reshape((-1, x.shape[-1]))
    return torch.abs(stft(flat, n_fft, hop_length, win_length))


def _single_resolution(pred: Tensor, target: Tensor, n_fft: int, hop: int,
                       win: int, eps: float) -> Tensor:
    sp = stft_magnitude(pred, n_fft, hop, win)
    st = stft_magnitude(target, n_fft, hop, win)
    # Spectral convergence: Frobenius norms over the whole flattened batch.
    sc = torch.linalg.vector_norm(st - sp) / (torch.linalg.vector_norm(st)
                                              + eps)
    log_mag = torch.mean(torch.abs(torch.log(st + eps) - torch.log(sp + eps)))
    return sc + log_mag


def multi_resolution_stft_loss(
    pred: Tensor,
    target: Tensor,
    fft_sizes: Sequence[int] = (1024, 2048, 512),
    hop_sizes: Sequence[int] = (120, 240, 50),
    win_lengths: Sequence[int] = (600, 1200, 240),
    eps: float = 1e-8,
) -> Tensor:
    """Mean of (spectral convergence + log-magnitude L1) over resolutions;
    the defaults are auraloss.MultiResolutionSTFTLoss's."""
    losses = [_single_resolution(pred, target, n, h, w, eps)
              for n, h, w in zip(fft_sizes, hop_sizes, win_lengths)]
    return torch.mean(torch.stack(losses))


class MultiResolutionSTFTLoss:
    """Callable wrapper for ``DiffusionModel(loss_fn=...)``."""

    def __init__(self, fft_sizes: Sequence[int] = (1024, 2048, 512),
                 hop_sizes: Sequence[int] = (120, 240, 50),
                 win_lengths: Sequence[int] = (600, 1200, 240)):
        self.resolutions: Tuple = tuple(
            zip(fft_sizes, hop_sizes, win_lengths))

    def __call__(self, pred: Tensor, target: Tensor) -> Tensor:
        fft, hop, win = zip(*self.resolutions)
        return multi_resolution_stft_loss(
            pred, target, fft_sizes=fft, hop_sizes=hop, win_lengths=win)
