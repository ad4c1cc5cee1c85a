"""Plain PyTorch reference of the training the benchmark drives: the crops a
device-resident corpus draws for each step, the v-objective loss with its
draws of σ and noise, the gradients, optax's chain of global-norm
clipping and Adam, and an exponential moving average of the parameters.

It imports nothing of the program under test: it reads the corpus's WAV
files itself and works out every crop, draw and update again.
"""
from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import Tensor

from .unet import FLOAT32, Precision, alpha_beta, net_forward

__all__ = ["read_pcm16", "write_pcm16", "Crops", "leaf_norms",
           "train_reference"]


def write_pcm16(path: Path, audio: np.ndarray, sample_rate: int) -> None:
    """A PCM16 WAV file of int16 ``audio`` [channels, frames]."""
    channels, frames = audio.shape
    data = np.ascontiguousarray(audio.T).astype("<i2").tobytes()
    header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data),
                         b"WAVE", b"fmt ", 16, 1, channels, sample_rate,
                         sample_rate * channels * 2, channels * 2, 16,
                         b"data", len(data))
    Path(path).write_bytes(header + data)


def read_pcm16(path: Path) -> np.ndarray:
    """int16 [channels, frames] of a PCM16 WAV file as :func:`write_pcm16`
    writes it (one ``fmt `` chunk, then ``data``)."""
    raw = Path(path).read_bytes()
    channels = struct.unpack_from("<H", raw, 22)[0]
    pos = 12
    while raw[pos:pos + 4] != b"data":
        pos += 8 + struct.unpack_from("<I", raw, pos + 4)[0]
    size = struct.unpack_from("<I", raw, pos + 4)[0]
    pcm = np.frombuffer(raw, "<i2", size // 2, pos + 8)
    return pcm.reshape(-1, channels).T.copy()


def _step_seed(seed: int, step: int) -> int:
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


class Crops:
    """The batch of each step: for step s a generator on the device seeded
    from (seed, s) draws each row's file uniformly, then its offset as
    floor(u·(frames − crop + 1)), u uniform in [0, 1); the rows are the
    crops at those offsets, dequantized x / 32768."""

    def __init__(self, files: Sequence[Path], crop: int, batch: int,
                 seed: int, device):
        audio = [read_pcm16(f) for f in sorted(files)]
        self.frames = [a.shape[1] for a in audio]
        self.corpus = torch.from_numpy(np.concatenate(audio, 1)).to(device)
        self.starts = torch.tensor(np.cumsum([0] + self.frames[:-1]),
                                   dtype=torch.int64, device=device)
        self.max_off = torch.tensor(np.asarray(self.frames) - crop,
                                    dtype=torch.int64, device=device)
        self.crop, self.batch, self.seed = crop, batch, seed
        self.device = device

    def batch_at(self, step: int) -> Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_step_seed(self.seed, step))
        idx = torch.randint(0, len(self.frames), (self.batch,), generator=gen,
                            device=self.device)
        u = torch.rand(self.batch, generator=gen, device=self.device)
        off = torch.minimum((u * (self.max_off[idx] + 1).float()).long(),
                            self.max_off[idx])
        pos = (self.starts[idx] + off)[:, None] + torch.arange(
            self.crop, device=self.device)
        rows = self.corpus[:, pos].transpose(0, 1)
        return rows.float() / 32768.0


def leaf_norms(tensors: Dict[str, Tensor]) -> Dict[str, float]:
    """The L2 norm of each tensor, in float64 on the host."""
    return {k: float(torch.linalg.vector_norm(t.double()))
            for k, t in tensors.items()}


def train_reference(params: Dict[str, Tensor], cfg: dict,
                    batches: List[Tensor], generator: torch.Generator,
                    lr: float, max_grad_norm: float, ema_decay: float,
                    pr: Precision = FLOAT32, betas=(0.9, 0.999),
                    eps: float = 1e-8, moments=None, ema=None,
                    start: int = 0) -> dict:
    """``len(batches)`` optimizer steps from ``params`` (copied, float32),
    after ``start`` steps whose Adam moments ``moments`` (μ, ν) and EMA
    ``ema`` are given (zeros and ``params`` where they are not; none of
    them is changed). Each step draws σ ~ U[0, 1) per row, then the
    noise, from
    ``generator``; the loss is the mean squared error of the net's v
    against α·noise − β·x at x_noisy = α·x + β·noise. The gradient is
    clipped to ``max_grad_norm`` by its global norm (where the norm
    reaches it), Adam updates with optax's bias corrections, and the EMA
    follows the updated parameters.

    Returns each step's loss, the first step's clipped gradient's norm by
    leaf, and by leaf the norms of the parameters' and the EMA's change
    over all the steps."""
    p0 = {k: v.detach().float() for k, v in params.items()}
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    ema0 = p0 if ema is None else {k: ema[k].float() for k in p0}
    ema = {k: v.clone() for k, v in ema0.items()}
    if moments is None:
        mu = {k: torch.zeros_like(v) for k, v in p0.items()}
        nu = {k: torch.zeros_like(v) for k, v in p0.items()}
    else:
        mu = {k: moments[0][k].float().clone() for k in p0}
        nu = {k: moments[1][k].float().clone() for k in p0}
    b1, b2 = betas
    losses, first_grad = [], None
    for step, x in enumerate(batches, start=start + 1):
        b = x.shape[0]
        sigmas = torch.rand((b,), generator=generator, dtype=torch.float32,
                            device=x.device)
        noise = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                            device=x.device)
        alpha, beta = alpha_beta(sigmas[:, None, None])
        v = net_forward(p, cfg, alpha * x + beta * noise, sigmas, pr=pr)
        loss = torch.mean((v - (alpha * noise - beta * x)) ** 2)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(float(loss.detach()))
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        if norm >= max_grad_norm:
            grads = {k: g / norm * max_grad_norm for k, g in grads.items()}
        if first_grad is None:
            first_grad = leaf_norms(grads)
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step
        with torch.no_grad():
            for k, g in grads.items():
                mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
                nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                update = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
                p[k].sub_(lr * update)
                ema[k].mul_(ema_decay).add_(p[k], alpha=1.0 - ema_decay)
    with torch.no_grad():
        change = leaf_norms({k: p[k] - p0[k] for k in p})
        ema_change = leaf_norms({k: ema[k] - ema0[k] for k in p})
    return dict(losses=losses, first_grad=first_grad, change=change,
                ema_change=ema_change)
