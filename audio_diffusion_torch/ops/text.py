"""Text encoders for text-conditional generation (counterpart of
audio_diffusion_tpu/ops/text.py). An encoder maps a list of captions to an
embedding ``[b, max_length, features]`` as a numpy array, once per model
call, on the host.

Only :class:`StubTextEncoder` is ported: deterministic hash-based
embeddings, not semantically meaningful, so the whole text-conditional path
(CFG, cross-attention, guided sampling) runs without T5 weights. It gives
the JAX package's arrays bit for bit.
"""
from __future__ import annotations

import hashlib
from typing import List

import numpy as np

__all__ = ["StubTextEncoder"]


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
