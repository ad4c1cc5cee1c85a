"""STFT and mel front end on ``torch.fft`` (counterpart of
audio_diffusion_tpu/dsp/mel.py), with the torchaudio defaults the reference
uses: a periodic Hann window, ``center=False``, a one-sided complex STFT,
and the HTK mel scale with f_min 0, f_max sample_rate / 2, no norm and
triangular filters. torchaudio is not needed.

Frames are strided views of the signal (``Tensor.unfold``), windowed and
transformed by ``torch.fft.rfft``; the inverse is an overlap-add
(``ops.conv.overlap_add``) divided by the summed squared window.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from ..ops.conv import overlap_add

__all__ = ["stft", "istft", "griffin_lim", "melscale_fbanks",
           "MelSpectrogram"]


def _framing_window(n_fft: int, win_length: int, device) -> Tensor:
    """Periodic Hann window of ``win_length``, zero-padded symmetrically to
    ``n_fft`` (as torch.stft pads a shorter window)."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win_length))
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def stft(x: Tensor, n_fft: int, hop_length: int,
         win_length: Optional[int] = None) -> Tensor:
    """One-sided complex STFT of [..., t], center=False:
    [..., n_fft//2+1, n_frames] (torch.stft's layout)."""
    win_length = win_length or n_fft
    t = x.shape[-1]
    if t < n_fft:
        raise ValueError(f"signal length {t} is shorter than n_fft {n_fft} "
                         "(a center=False STFT needs at least one full frame)")
    window = _framing_window(n_fft, win_length, x.device)
    frames = x.unfold(-1, n_fft, hop_length) * window  # [..., frames, n_fft]
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def istft(spec: Tensor, n_fft: int, hop_length: int,
          win_length: Optional[int] = None,
          length: Optional[int] = None) -> Tensor:
    """Inverse of :func:`stft` (center=False): windowed overlap-add divided
    by max(Σ window², 1e-11). spec [..., n_fft//2+1, n_frames] -> [..., t],
    t = ``length`` (frames beyond it are dropped, samples beyond the last
    frame are zero) or (n_frames − 1)·hop + n_fft."""
    win_length = win_length or n_fft
    window = _framing_window(n_fft, win_length, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    out = overlap_add(frames * window, hop_length)  # [..., natural]
    wsq = overlap_add((window ** 2).expand(frames.shape[-2], n_fft),
                      hop_length)
    natural = out.shape[-1]
    t = length or natural
    if t != natural:
        out = F.pad(out, (0, t - natural)) if t > natural else out[..., :t]
        wsq = F.pad(wsq, (0, t - natural)) if t > natural else wsq[:t]
    return out / torch.clamp(wsq, min=1e-11)


def griffin_lim(magnitude: Tensor, n_fft: int, hop_length: int,
                win_length: Optional[int] = None, n_iter: int = 32,
                length: Optional[int] = None) -> Tensor:
    """Griffin-Lim phase reconstruction from an STFT magnitude
    [..., n_fft//2+1, n_frames] -> waveform [..., t]: from zero phase,
    ``n_iter`` projections between the magnitude and the consistent STFTs.
    The phasor is built from cos/sin, as the JAX package builds it."""
    mag = magnitude.float()

    def phasor(angles: Tensor) -> Tensor:
        return torch.complex(torch.cos(angles), torch.sin(angles))

    angles = torch.zeros_like(mag)
    for _ in range(n_iter):
        x = istft(mag * phasor(angles), n_fft, hop_length, win_length,
                  length=length)
        rebuilt = stft(x, n_fft, hop_length, win_length)
        # The STFT of a len-`length` signal can lose a trailing partial
        # frame; the previous phase stays there.
        f = rebuilt.shape[-1]
        new = torch.angle(rebuilt)
        angles = (torch.cat([new, angles[..., f:]], dim=-1)
                  if f < angles.shape[-1] else new[..., :angles.shape[-1]])
    return istft(mag * phasor(angles), n_fft, hop_length, win_length,
                 length=length)


def _hz_to_mel_htk(freq: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + freq / 700.0)


def _mel_to_hz_htk(mel: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def melscale_fbanks(n_freqs: int, n_mels: int, sample_rate: int,
                    f_min: float = 0.0,
                    f_max: Optional[float] = None) -> np.ndarray:
    """Triangular HTK mel filterbank [n_freqs, n_mels] in float32 numpy
    (torchaudio's melscale_fbanks with norm=None, mel_scale='htk')."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(np.array(f_min)),
                        _hz_to_mel_htk(np.array(f_max)), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)


class MelSpectrogram:
    """Waveform [..., t] -> mel [..., n_mels, n_frames]. Parameterless (the
    filterbank is a constant, kept on each device it is used on).

    The signal is reflect-padded (n_fft − hop)/2 on both sides. With
    ``normalize`` the mel is divided by its one largest value over the whole
    batch, then mapped to 2·mel^¼ − 1; with ``normalize_log`` it becomes
    log(max(mel, 1e-5)) (after the former, when both are set)."""

    def __init__(self, n_fft: int, hop_length: int, win_length: int,
                 sample_rate: int, n_mel_channels: int, center: bool = False,
                 normalize: bool = False, normalize_log: bool = False):
        if center:
            raise ValueError("MelSpectrogram supports center=False only")
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.sample_rate = sample_rate
        self.n_mel_channels = n_mel_channels
        self.normalize = normalize
        self.normalize_log = normalize_log
        self.padding = (n_fft - hop_length) // 2
        self._fbanks_host = torch.from_numpy(melscale_fbanks(
            n_freqs=n_fft // 2 + 1, n_mels=n_mel_channels,
            sample_rate=sample_rate))
        self._fbanks: Dict[torch.device, Tensor] = {}

    def _fbanks_on(self, device) -> Tensor:
        """The [n_freqs, n_mels] filterbank on ``device`` (copied there
        once, not at each call)."""
        device = torch.device(device)
        if device not in self._fbanks:
            self._fbanks[device] = self._fbanks_host.to(device)
        return self._fbanks[device]

    def __call__(self, waveform: Tensor) -> Tensor:
        leading = waveform.shape[:-1]
        x = waveform.reshape((-1, 1, waveform.shape[-1]))  # pack "* t"
        x = F.pad(x, (self.padding, self.padding), mode="reflect")[:, 0]
        magnitude = torch.abs(stft(x, self.n_fft, self.hop_length,
                                   self.win_length))  # [N, n_freq, frames]
        mel = torch.einsum("nfl,fm->nml", magnitude,
                           self._fbanks_on(x.device).to(magnitude.dtype))
        if self.normalize:
            mel = mel / torch.max(mel)
            mel = 2.0 * torch.pow(mel, 0.25) - 1.0
        if self.normalize_log:
            mel = torch.log(torch.clamp(mel, min=1e-5))
        return mel.reshape(leading + mel.shape[1:])  # unpack "* f l"
