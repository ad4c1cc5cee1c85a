"""Text encoders for text-conditional generation (counterpart of
audio_diffusion_tpu/ops/text.py). An encoder maps a list of captions to an
embedding ``[b, max_length, features]`` as a numpy array, once per model
call, on the host.

- :class:`RandomT5TextEncoder`: the T5 encoder stack (``ops.t5``) with
  frozen random weights and a byte-level tokenizer (ids = byte + 3, 0 is
  padding). Semantically meaningless, but it runs the real architecture
  (relative-position bias, padding mask, tokenize -> encode -> mask).
- :class:`StubTextEncoder`: deterministic hash-based embeddings, not
  semantically meaningful, so the text-conditional path runs without any
  weights. It gives the JAX package's arrays bit for bit.

The pretrained ``T5TextEncoder`` (``t5-base``) waits for its weights, which
are not in the repository.
"""
from __future__ import annotations

import hashlib
from typing import List

import numpy as np
import torch

from ..utils import resolve_device
from .t5 import T5EncoderStack

__all__ = ["RandomT5TextEncoder", "StubTextEncoder"]


class RandomT5TextEncoder:
    """The T5 encoder stack with frozen random weights (no downloads): the
    config of the JAX package's encoder (d_ff = 2·features, d_kv =
    features / heads, a 259-token vocabulary), weights drawn from a CPU
    ``torch.Generator`` seeded with ``seed`` at the standard deviations of
    Flax T5's initializers, so one seed gives the same weights on every
    device. The stack runs on ``device`` (``None`` means the CUDA card).
    Flax's own draw cannot be reproduced; load Flax weights with
    ``stack.load_state_dict(convert.t5_params_from_flax(params))``.

    ``encoder(texts)`` -> numpy [b, max_length, features]: the stack's f32
    output times the int32 padding mask, which is float64, as the JAX
    package's is."""

    def __init__(self, max_length: int = 64, features: int = 768,
                 num_layers: int = 2, num_heads: int = 4, seed: int = 0,
                 device=None):
        self.max_length = max_length
        self.features = features
        self.device = resolve_device(device)
        self.stack = T5EncoderStack(
            d_model=features, d_ff=2 * features, num_layers=num_layers,
            num_heads=num_heads, device=self.device)
        self.stack.init_params(torch.Generator().manual_seed(seed))
        self.stack.requires_grad_(False)

    def _tokenize(self, texts: List[str]) -> np.ndarray:
        """UTF-8 bytes truncated to ``max_length`` bytes, ids = byte + 3,
        0 as padding: int32 [b, max_length]."""
        ids = np.zeros((len(texts), self.max_length), np.int32)
        for i, text in enumerate(texts):
            raw = text.encode("utf-8")[: self.max_length]
            ids[i, : len(raw)] = np.frombuffer(raw, np.uint8) + 3
        return ids

    def __call__(self, texts: List[str]) -> np.ndarray:
        ids = self._tokenize(texts)
        mask = (ids != 0).astype(np.int32)
        with torch.inference_mode():
            out = self.stack(torch.from_numpy(ids).long().to(self.device),
                             torch.from_numpy(mask).to(self.device))
        return out.cpu().numpy() * mask[..., None]


class StubTextEncoder:
    """Deterministic pseudo-embeddings from a text hash (offline stand-in)."""

    def __init__(self, max_length: int = 64, features: int = 768):
        self.max_length = max_length
        self.features = features

    def __call__(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.max_length, self.features),
                       dtype=np.float32)
        for i, text in enumerate(texts):
            digest = hashlib.sha256(text.encode("utf-8")).digest()
            seed = int.from_bytes(digest[:8], "little") % (2**31)
            rng = np.random.default_rng(seed)
            n = min(len(text.split()) + 1, self.max_length)
            out[i, :n] = rng.standard_normal((n, self.features)) * 0.05
        return out
