"""Device-resident corpus: upload the training data once, crop on the device
(counterpart of audio_diffusion_tpu/data/device.py).

A host dataloader uploads every batch (8 x 2 x 2^18 int16 samples is 8.4 MB
per step) and decodes on the host that also dispatches the step.
:class:`DeviceCorpus` uploads the corpus once, as one ``[channels,
total_frames]`` tensor on the card (int16 for PCM16 sources: lossless, half
of float32's footprint), and builds every batch on the card: it draws
(file, offset) with the same two-level distribution as ``AudioDataset``
(the file uniform, then the offset uniform over ``[0, frames - crop]``)
from a ``torch.Generator`` on the device seeded from ``(seed, step)``, and
gathers the ``[batch, channels, crop]`` windows in one indexing op.

Usage (drop-in for ``AudioDataset`` in ``Trainer.fit``)::

    dc = DeviceCorpus("wavs/", crop_frames=2**18, batch_size=8)
    trainer.fit(iter(dc), num_steps=30_000)

The random stream differs from the JAX package's (threefry) and from
``AudioDataset``'s (numpy); the distribution is the same. int16 corpora
yield int16 batches, which the train step dequantizes x / 32768 on the
device, bit-exact against the float32 decode.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..utils import resolve_device
from .loader import AudioDataset, read_batch, wav_read

__all__ = ["DeviceCorpus"]


def _step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed that is a pure function of (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


class DeviceCorpus:
    """Random-crop sampler over a directory of WAV files, held on the device.

    Parameters mirror :class:`AudioDataset` (source, crop_frames,
    batch_size, channels, seed, host_id/num_hosts file sharding, dtype
    auto/int16/float32). ``max_bytes`` guards device memory: construction
    refuses a corpus whose device footprint would exceed it (default 2 GiB
    — training state needs the rest; use ``AudioDataset`` for bigger sets).
    ``device`` is the CUDA card unless the caller passes another (the CPU
    for tests). ``mesh`` (multi-GPU placement) is not ported yet.
    """

    def __init__(
        self,
        source,
        crop_frames: int,
        batch_size: int,
        channels: Optional[int] = None,
        seed: int = 0,
        host_id: Optional[int] = None,
        num_hosts: Optional[int] = None,
        dtype: str = "auto",
        max_bytes: int = 2 << 30,
        mesh=None,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "DeviceCorpus mesh= (a corpus replicated over several GPUs) "
                "is not ported yet (ROADMAP Queue 1, item 4)")
        self.device = resolve_device(device)
        # Reuse AudioDataset's discovery/validation/probe pass: file list,
        # channel resolution, too-short/mismatch skips, PCM16 detection.
        ds = AudioDataset(source, crop_frames=crop_frames,
                          batch_size=batch_size, channels=channels,
                          seed=seed, host_id=host_id, num_hosts=num_hosts,
                          dtype=dtype)
        self.files = ds.files
        self.frames = ds.frames
        self.channels = ds.channels
        self.sample_rate = ds.sample_rate
        self.dtype = ds.dtype
        self.crop_frames = crop_frames
        self.batch_size = batch_size
        self.seed = seed

        total = int(np.sum(self.frames))
        nbytes = total * self.channels * self.dtype.itemsize
        if nbytes > max_bytes:
            raise ValueError(
                f"corpus is {nbytes/2**30:.2f} GiB on device "
                f"(> max_bytes={max_bytes/2**30:.2f} GiB): use the host "
                "AudioDataset, or raise max_bytes if device memory allows")

        # Concatenate along time. int16 sources decode losslessly through
        # the native PCM16 batch reader (one full-length crop per file).
        parts = [read_batch([f], np.zeros(1), self.channels, n,
                            self.dtype)[0] if self.dtype == np.int16
                 else wav_read(f) for f, n in zip(self.files, self.frames)]
        flat = np.concatenate(parts, axis=1)  # [C, total]
        self._corpus = torch.from_numpy(flat).to(self.device)
        self._starts = torch.as_tensor(
            np.cumsum([0] + self.frames[:-1]), dtype=torch.int64,
            device=self.device)
        self._max_off = torch.as_tensor(
            np.asarray(self.frames) - crop_frames, dtype=torch.int64,
            device=self.device)
        self._window = torch.arange(crop_frames, device=self.device)

    @property
    def device_bytes(self) -> int:
        return self._corpus.numel() * self._corpus.element_size()

    def batch_at(self, step: int) -> torch.Tensor:
        """The batch for one step index ([B, C, crop] on the device; int16
        when the corpus is PCM16). Pure in ``(seed, step)``, so any
        iteration order or resume point reproduces the same data."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_step_seed(self.seed, step))
        b = self.batch_size
        idx = torch.randint(0, len(self.files), (b,), generator=gen,
                            device=self.device)
        # Offset as floor(u * (max_off + 1)): uniform under a per-file bound
        # held on the device (randint takes one bound for all rows).
        u = torch.rand(b, generator=gen, device=self.device)
        max_off = self._max_off[idx]
        off = (u * (max_off + 1).float()).long()
        off = torch.minimum(off, max_off)  # u ~ 1.0 edge
        flat = self._starts[idx] + off
        windows = self._corpus[:, flat[:, None] + self._window]  # [C, B, T]
        return windows.transpose(0, 1).contiguous()

    def __iter__(self) -> Iterator[torch.Tensor]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
