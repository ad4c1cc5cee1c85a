"""Corpus-trained audio embedder for embedding-space Fréchet evaluation
(counterpart of audio_diffusion_tpu/embed.py).

A small embedder trained on the corpus itself — a log-mel front end, a
strided conv stack and a cosine-softmax file-classification head — whose
L2-normalized pre-logits features give a Fréchet distance in a learned
embedding space (the FAD recipe, Kilgour et al. 2019, without pretrained
weights)::

    emb = CorpusEmbedder()
    params = emb.train(files)                    # [n, c, t] corpus audio
    feats = emb.embed(params, samples)           # [b, d] unit vectors
    fed = frechet_embedding_distance(feats_ref, feats_gen)

File identity is a free supervised signal: separating the files forces the
features to encode texture and temporal structure, not just the long-term
spectrum. The embedder runs on the card unless ``device="cpu"`` is passed;
the corpus stays on its device while training, and each step's file
indices and crop positions are drawn through ``diffusion/noise.py``.
Parameters cross from the JAX package with
``convert.embedder_params_from_flax``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn
from torch.func import functional_call

from .diffusion import noise
from .dsp import MelSpectrogram
from .eval import _frechet_gaussian
from .ops.layers import Dense, init_module, lecun_normal_
from .utils import resolve_device

__all__ = ["CorpusEmbedder", "frechet_embedding_distance"]

_KERNEL, _STRIDE = 5, 2


def _same_pad(h: Tensor) -> Tensor:
    """Flax ``padding="SAME"`` for the stride-2, width-5 conv: ceil(L / 2)
    outputs, the total pad split low = pad // 2, high = pad − low (so an
    odd frame count pads one more on the right)."""
    length = h.shape[-1]
    out = -(-length // _STRIDE)
    pad = max((out - 1) * _STRIDE + _KERNEL - length, 0)
    return F.pad(h, (pad // 2, pad - pad // 2))


class _EmbedNet(nn.Module):
    """Strided conv stack over log-mel frames -> (unit embedding, logits).
    Layers are named as the Flax module's (``Conv_i``, ``Dense_0`` the
    embedding, ``Dense_1`` the head)."""

    def __init__(self, n_mels: int, features: int, num_classes: int,
                 widths: Tuple[int, ...]):
        super().__init__()
        self.num_classes = num_classes
        self.widths = widths
        for i, (cin, w) in enumerate(zip((n_mels,) + widths[:-1], widths)):
            self.add_module(f"Conv_{i}", nn.Conv1d(cin, w, _KERNEL,
                                                   stride=_STRIDE))
        self.Dense_0 = Dense(2 * widths[-1], features)
        self.Dense_1 = Dense(features, num_classes, bias=False)

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        """flax's Conv init (lecun-normal kernel, zero bias); the Dense
        layers init themselves."""
        for i in range(len(self.widths)):
            conv = getattr(self, f"Conv_{i}")
            lecun_normal_(conv.weight, conv.in_channels * _KERNEL, generator)
            nn.init.zeros_(conv.bias)

    def forward(self, mel: Tensor) -> Tuple[Tensor, Tensor]:  # [b, mels, f]
        h = mel
        for i in range(len(self.widths)):
            h = F.gelu(getattr(self, f"Conv_{i}")(_same_pad(h)),
                       approximate="tanh")
        # Mean and std over time: texture and its variability (ε inside the
        # roots: their gradients at zero variance are NaN otherwise).
        std = torch.sqrt(h.var(dim=-1, correction=0) + 1e-6)
        h = torch.cat([h.mean(dim=-1), std], dim=-1)
        e = self.Dense_0(h)
        e = e * torch.rsqrt(torch.sum(e * e, dim=-1, keepdim=True) + 1e-8)
        # Cosine-softmax head: a scaled dot with the unit embedding.
        return e, self.Dense_1(e * 16.0)


class CorpusEmbedder:
    """Self-supervised-by-file-identity audio embedder.

    ``features`` (default 32), the mel geometry and the conv ``widths`` set
    the net. ``train`` takes an ``[n_files, channels, frames]`` array (or
    list) of corpus audio and learns to classify random crops by source
    file; ``embed`` maps any ``[b, channels, t]`` batch (t >= crop) to
    ``[b, features]`` unit vectors (host numpy). Parameters are a dict of
    tensors on the embedder's device."""

    def __init__(self, *, features: int = 32, sample_rate: int = 48000,
                 crop: int = 48000, n_mels: int = 64, n_fft: int = 1024,
                 hop: int = 256, widths: Tuple[int, ...] = (96, 128, 192),
                 device=None):
        self.device = resolve_device(device)
        self.features = features
        self.sample_rate = sample_rate
        self.crop = crop
        self.n_mels = n_mels
        self.widths = tuple(widths)
        self._mel = MelSpectrogram(
            n_fft=n_fft, hop_length=hop, win_length=n_fft,
            sample_rate=sample_rate, n_mel_channels=n_mels,
            normalize_log=True)
        self._net: Optional[_EmbedNet] = None

    def _build(self, num_classes: int) -> _EmbedNet:
        if self._net is None or self._net.num_classes != num_classes:
            self._net = _EmbedNet(self.n_mels, self.features, num_classes,
                                  self.widths).to(self.device)
        return self._net

    def _mel_mono(self, x: Tensor) -> Tensor:
        # Mono mix before the mel front end: the channel layout must not
        # leak into the metric.
        return self._mel(x.mean(dim=1))

    def _audio(self, x) -> Tensor:
        if isinstance(x, Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

    # -------------------------------------------------------------- train
    def train(self, files, *, generator: Optional[torch.Generator] = None,
              steps: int = 1500, batch: int = 32, lr: float = 3e-4,
              log_every: int = 0) -> Dict[str, Tensor]:
        """Train on random crops labelled by source file; returns the
        parameters. ``files``: [n_files, channels, frames] (frames >= crop),
        kept whole on the embedder's device. The parameters are drawn, then
        each step's file indices and crop positions, from ``generator``
        (default: seeded 0, on the embedder's device). AdamW as
        ``optax.adamw(lr)``: weight decay 1e-4, eps 1e-8."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        files = self._audio(files)
        n_files, channels, frames = files.shape
        assert frames >= self.crop, (files.shape, self.crop)
        net = self._build(n_files)
        init_module(net, generator)
        opt = torch.optim.AdamW(net.parameters(), lr=lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4)
        chans = torch.arange(channels, device=self.device)[None, :, None]
        window = torch.arange(self.crop, device=self.device)
        for i in range(steps):
            idx = noise.randint(generator, 0, n_files, (batch,), self.device)
            pos = noise.randint(generator, 0, frames - self.crop + 1,
                                (batch,), self.device)
            crops = files[idx[:, None, None], chans,
                          (pos[:, None] + window)[:, None, :]]
            _, logits = net(self._mel_mono(crops))
            loss = F.cross_entropy(logits, idx)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            if log_every and (i + 1) % log_every == 0:
                acc = (logits.argmax(-1) == idx).float().mean()
                print(f"embedder step {i + 1}: loss={float(loss):.3f} "
                      f"acc={float(acc):.2f}", flush=True)
        return {k: v.detach().clone() for k, v in net.named_parameters()}

    # -------------------------------------------------------------- embed
    @torch.no_grad()
    def embed(self, params: Dict[str, Tensor], audio) -> np.ndarray:
        """[b, channels, t] -> [b, features] unit vectors (host numpy).

        Long audio is cut into non-overlapping ``crop`` windows whose
        embeddings are averaged, then renormalized (the FAD recipe's
        per-window pooling). ``params`` may come from :meth:`train`,
        :meth:`load` or ``convert.embedder_params_from_flax``."""
        net = self._build(params["Dense_1.weight"].shape[0])
        x = self._audio(audio)
        assert x.ndim == 3, f"expected [b, channels, t], got {x.shape}"
        assert x.shape[-1] >= self.crop, (x.shape, self.crop)
        embs = []
        for w in range(max(x.shape[-1] // self.crop, 1)):
            mel = self._mel_mono(x[..., w * self.crop:(w + 1) * self.crop])
            e, _ = functional_call(net, params, (mel,))
            embs.append(e.cpu().numpy())
        e = np.mean(embs, axis=0)
        return e / (np.linalg.norm(e, axis=-1, keepdims=True) + 1e-6)

    # ------------------------------------------------------------ persist
    def save(self, params: Dict[str, Tensor], path) -> None:
        """Write ``params`` to ``path`` (``torch.save``)."""
        torch.save(dict(params), path)

    def load(self, path, num_classes: int) -> Dict[str, Tensor]:
        """Parameters written by :meth:`save`, on the embedder's device
        (``num_classes`` must be the training corpus's file count; strict:
        every name and shape must match)."""
        net = self._build(num_classes)
        state = torch.load(path, map_location=self.device, weights_only=True)
        net.load_state_dict(state, strict=True)
        return {k: v.detach().clone() for k, v in net.named_parameters()}


def frechet_embedding_distance(feats_ref, feats_gen,
                               shrinkage: float = 1e-3) -> float:
    """Fréchet (Wasserstein-2) distance between two sets of embeddings
    ``[n, d]``; ``shrinkage`` diag-loads both covariances by that fraction
    of the mean variance (small sets of unit-norm features)."""
    a = np.asarray(feats_ref, np.float64)
    b = np.asarray(feats_gen, np.float64)
    assert a.ndim == b.ndim == 2 and a.shape[1] == b.shape[1], (
        a.shape, b.shape)
    assert a.shape[0] >= 2 and b.shape[0] >= 2, "need >= 2 items per set"
    return _frechet_gaussian(a, b, ridge=0.0, shrinkage=shrinkage)
