"""Operations of one pass of the 1-D U-Net, counted from its configuration
and the input's shape (see the package docstring for what counts)."""
from __future__ import annotations

from typing import Iterator, Optional, Tuple


def item_shapes(cfg: dict, batch: int, length: int
                ) -> Iterator[Tuple[int, int, int]]:
    """(batch, length, channels) of every resnet item one pass runs, down
    path then up path."""
    n = len(cfg["channels"])
    lengths = []
    for f in cfg["factors"]:
        length //= f
        lengths.append(length)
    for i in list(range(n)) + list(reversed(range(n))):
        for _ in range(cfg["items"][i]):
            yield batch, lengths[i], cfg["channels"][i]


def forward_flops(cfg: dict, batch: int, length: int,
                  embedding_length: Optional[int] = None) -> int:
    """FLOPs (2 per multiply-add) of the matrix products of one forward
    pass at ``batch`` rows of ``length`` samples. Cross-attention attends
    to ``embedding_length`` rows (the configuration's
    ``embedding_max_length`` unless given)."""
    n = len(cfg["channels"])
    ch, fac, items = cfg["channels"], cfg["factors"], cfg["items"]
    attn = cfg.get("attentions", [0] * n)
    cross = cfg.get("cross_attentions", [0] * n)
    feats = cfg.get("modulation_features", 1024)
    inner = cfg.get("attention_heads", 8) * cfg.get("attention_features", 64)
    emb = cfg.get("embedding_features") or 0
    tokens = embedding_length or cfg.get("embedding_max_length") or 0
    out_c = cfg.get("out_channels", cfg["in_channels"])
    b = batch
    total = 2 * b * (257 * feats + feats * feats)  # σ embedding
    prev, lengths = cfg["in_channels"], []
    for i in range(n):
        length //= fac[i]
        lengths.append(length)
        total += 2 * b * length * fac[i] * prev * ch[i]  # downsample
        prev = ch[i]
    for i in range(n):
        c, l = ch[i], lengths[i]
        per_item = 12 * b * l * c * c + 2 * b * feats * 2 * c  # convs, gate
        ff = 2 * 2 * b * l * c * 4 * c
        self_attn = (2 * b * l * c * 3 * inner + 2 * 2 * b * l * l * inner
                     + 2 * b * l * inner * c + ff)
        cross_attn = (2 * b * l * c * inner + 2 * 2 * b * tokens * emb * inner
                      + 2 * 2 * b * l * tokens * inner
                      + 2 * b * l * inner * c + ff)
        per_item += attn[i] * self_attn + cross[i] * cross_attn
        total += 2 * items[i] * per_item  # down and up stacks
        if i < n - 1:
            total += 2 * b * feats * c  # skip gate
        up_c = ch[i - 1] if i > 0 else ch[0]
        total += 2 * b * l * c * fac[i] * up_c  # upsample
    total += 2 * b * lengths[0] * fac[0] * 3 * ch[0] * out_c  # output conv
    return total


def train_flops(cfg: dict, batch: int, length: int) -> int:
    """A training step: the forward and a backward of twice its products,
    no recomputation."""
    return 3 * forward_flops(cfg, batch, length)
