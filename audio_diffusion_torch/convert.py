"""Weights carried between the JAX package and the port.

``params_from_jax(tree)`` takes the JAX ``UNetV0`` parameter tree as nested
dicts of arrays and returns the port's ``state_dict``, which
``net.module.load_state_dict(strict=True)`` accepts. ``params_to_jax(state)``
is its inverse: the nested dict of float32 numpy arrays that the JAX
``UNetV0`` takes. The tree is, from the outside in, any of the net
plugins' wrappers (``LTPlugin``: ``{"inner", "encode", "decode"}``;
``AppendChannelsPlugin``: ``{"inner"}`` alone), time conditioning
(``{"inner": ..., "sigma_embedding": ...}``), classifier-free guidance
(``{"inner": {xunet...}, "fixed_embedding": ...}``) and the XUNet; a net
without one of the wrappers lacks that level.

A task model's whole tree, as the JAX model's ``params`` holds it
(``{"net": ..., "encoder": {"params": ...}}`` for ``DiffusionAE`` with
``MelEncoder1d``, ``{"net": ..., "to_flat": {"params": ...}}`` for
``DiffusionVocoder``, ``{"net": ...}`` for the others), maps to the
model's ``params``: the net's names as they are, the extras' as
``"encoder/<name>"`` and ``"to_flat/<name>"``.

Layouts: a flax Dense kernel [in, out] becomes an ``nn.Linear`` weight
[out, in]; LayerNorm and GroupNorm keep ``scale``/``bias``; conv3 kernels
[3, Cin, Cout], the width-changing item's ``shortcut_kernel`` [Cin, C],
Downsample [d·Cin, Cout], Upsample [Cin, d·Cout] and SkipCat [2C, C]
kernels, the 2-D/3-D nets' conv kernels [3, 3(, 3), Cin, Cout]
(``...Conv_0.kernel``) and ``fixed_embedding`` keep their layout. The
2-D/3-D nets (``XUNet2d``/``XUNet3d``, told apart by their ``proj_out``)
keep flax's per-class names inside an item stack (``ResnetItem2d_k``,
``ModulationItem2d_k``, the context ``Dense_k``, ``AttentionItem_k``,
``CrossAttentionItem_k``); their patch layers, skips and context
projections are Dense layers. Port names are the JAX paths
joined by dots, with a Dense's ``kernel`` named ``weight``. Both directions
are strict: a leftover or a missing leaf raises.

``train_state_from_jax(state)`` takes the JAX ``TrainState`` (its fields
``step``, ``params``, ``opt_state``, ``ema``; arrays as numpy or JAX
arrays) of an ``optax.adam``/``adamw`` (optionally chained after
``clip_by_global_norm`` or with a schedule) and returns the content that
``train.Trainer.load_state_dict`` takes: the step, the parameters, Adam's
``exp_avg``/``exp_avg_sq``/``step`` per parameter from optax's
``mu``/``nu``/``count``, and the EMA. The generator is left as the trainer
has it (a threefry key has no torch counterpart). Strict as well: an
optimizer state other than these raises.

Quantized leaves (``ops/quant.py``) cross both ways. A JAX ``QTensor``
(anything with ``q``, ``qscale``, ``orig_dtype``, ``bits`` and
``orig_shape``) becomes the port's :class:`~.ops.quant.QTensor` with the
same int8 values and float32 scales; under a Dense kernel its ``q`` and
scale are transposed with it (``channel_axis=0``, the scales [out, 1]).
``params_to_jax`` turns a port QTensor back into the JAX layout, as a
leaf built by its ``qtensor`` argument (the JAX package's ``QTensor`` to
run the tree there).

``t5_params_from_flax(params)`` takes the Flax T5 encoder's parameter tree
(``FlaxT5EncoderModel.params``) and returns the ``state_dict`` of
``ops.t5.T5EncoderStack``, also strictly.

``embedder_params_from_flax(params)`` takes the JAX ``CorpusEmbedder``'s
parameter tree (``{"params": {"Conv_i": ..., "Dense_0": ...,
"Dense_1": ...}}``) and returns the port embedder's parameters
(``embed.CorpusEmbedder.train``'s dict): a Conv kernel [k, in, out]
becomes an ``nn.Conv1d`` weight [out, in, k], a Dense kernel [in, out] an
``nn.Linear`` weight [out, in]. ``embedder_params_to_flax(params)`` is its
inverse. Both strict.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import Tensor

from .ops.quant import QTensor

__all__ = ["params_from_jax", "params_to_jax", "t5_params_from_flax",
           "train_state_from_jax", "embedder_params_from_flax",
           "embedder_params_to_flax"]

_RESNET_LEAVES = ("gn1_scale", "gn1_bias", "conv1_kernel", "conv1_bias",
                  "gn2_scale", "gn2_bias", "conv2_kernel", "conv2_bias")
_ITEM = re.compile(r"(ResnetMod|InjectChannels|Attention|CrossAttention)"
                   r"Item_\d+")
# Flax's per-class names inside ItemStack2d/3d.
_ITEM_ND = re.compile(r"(ResnetItem|ModulationItem|Dense|AttentionItem|"
                      r"CrossAttentionItem)(?:[23]d)?_\d+")


class _Walk:
    """Pops leaves off a copy of the JAX tree into a flat dict of port names
    -> (array, is a Dense kernel)."""

    def __init__(self, caller: str):
        self.caller = caller
        self.out: Dict[str, tuple] = {}

    def take(self, node: dict, key: str, where: str):
        if key not in node:
            raise ValueError(f"{self.caller}: missing leaf {key!r} under "
                             f"{where or '<root>'}")
        return node.pop(key)

    def leaf(self, node: dict, key: str, prefix: str):
        self.out[prefix + key] = (self.take(node, key, prefix), False)

    def done(self, node: dict, where: str) -> None:
        if node:
            raise ValueError(f"{self.caller}: unconsumed leaves under "
                             f"{where or '<root>'}: {sorted(node)}")

    def dense(self, node: dict, prefix: str) -> None:
        self.out[prefix + "weight"] = (self.take(node, "kernel", prefix), True)
        if "bias" in node:
            self.leaf(node, "bias", prefix)
        self.done(node, prefix)

    def child(self, node: dict, key: str, prefix: str, fn) -> None:
        fn(self.take(node, key, prefix), f"{prefix}{key}.")

    def layer_norm(self, node: dict, prefix: str) -> None:
        self.leaf(node, "scale", prefix)
        self.leaf(node, "bias", prefix)
        self.done(node, prefix)

    def resnet_item(self, node: dict, prefix: str) -> None:
        for key in _RESNET_LEAVES:
            self.leaf(node, key, prefix)
        if "shortcut_kernel" in node:  # channel_change="first_item"
            self.leaf(node, "shortcut_kernel", prefix)
            self.leaf(node, "shortcut_bias", prefix)
        if "mod_dense" in node:
            self.leaf(node, "mod_gn_scale", prefix)
            self.leaf(node, "mod_gn_bias", prefix)
            self.child(node, "mod_dense", prefix, self.dense)
        self.done(node, prefix)

    def inject_item(self, node: dict, prefix: str) -> None:
        self.child(node, "Dense_0", prefix, self.dense)
        self.done(node, prefix)

    def attention_item(self, node: dict, prefix: str) -> None:
        self.child(node, "LayerNorm_0", prefix, self.layer_norm)
        self.child(node, "LayerNorm_1", prefix, self.layer_norm)
        attn = self.take(node, "Attention_0", prefix)
        where = prefix + "Attention_0."
        # Self-attention projects with to_qkv, cross-attention with
        # to_q/to_k/to_v; both end in to_out.
        keys = ("to_qkv",) if "to_qkv" in attn else ("to_q", "to_k", "to_v")
        for key in keys + ("to_out",):
            self.child(attn, key, where, self.dense)
        self.done(attn, where)
        ff = self.take(node, "FeedForward_0", prefix)
        for key in ("Dense_0", "Dense_1"):
            self.child(ff, key, prefix + "FeedForward_0.", self.dense)
        self.done(ff, prefix + "FeedForward_0.")
        self.done(node, prefix)

    def item_stack(self, node: dict, prefix: str) -> None:
        for item in [k for k in node if _ITEM.fullmatch(k)]:
            kind = _ITEM.fullmatch(item).group(1)
            fn = {"ResnetMod": self.resnet_item,
                  "InjectChannels": self.inject_item}.get(
                      kind, self.attention_item)
            self.child(node, item, prefix, fn)
        self.done(node, prefix)

    def conv(self, node: dict, prefix: str) -> None:
        """The JAX package's ``Conv2d``/``Conv3d``: flax ``nn.Conv`` as
        ``Conv_0``."""
        conv = self.take(node, "Conv_0", prefix)
        for key in ("kernel", "bias"):
            self.leaf(conv, key, f"{prefix}Conv_0.")
        self.done(conv, f"{prefix}Conv_0.")
        self.done(node, prefix)

    def item_stack_nd(self, node: dict, prefix: str) -> None:
        for item in [k for k in node if _ITEM_ND.fullmatch(k)]:
            kind = _ITEM_ND.fullmatch(item).group(1)
            fn = {"ResnetItem": self.resnet_item_nd,
                  "ModulationItem": self.modulation_item_nd,
                  "Dense": self.dense}.get(kind, self.attention_item)
            self.child(node, item, prefix, fn)
        self.done(node, prefix)

    def resnet_item_nd(self, node: dict, prefix: str) -> None:
        conv = "Conv3d" if "Conv3d_0" in node else "Conv2d"
        for key in ("GroupNorm_0", "GroupNorm_1"):
            self.child(node, key, prefix, self.layer_norm)
        for key in (f"{conv}_0", f"{conv}_1"):
            self.child(node, key, prefix, self.conv)
        self.done(node, prefix)

    def modulation_item_nd(self, node: dict, prefix: str) -> None:
        self.child(node, "GroupNorm_0", prefix, self.layer_norm)
        self.child(node, "Dense_0", prefix, self.dense)
        self.done(node, prefix)

    def xunet_nd(self, node: dict, prefix: str) -> None:
        """``XUNet2d``/``XUNet3d``: Dense-based patches and skips, flax
        ``GroupNorm_0`` and the ``proj_out`` conv."""
        self.child(node, "GroupNorm_0", prefix, self.layer_norm)
        self.child(node, "proj_out", prefix, self.conv)
        for key in [k for k in node if re.fullmatch(r"(down|up)_\d+", k)]:
            sub = node.pop(key)
            self.child(sub, "Dense_0", f"{prefix}{key}.", self.dense)
            self.done(sub, f"{prefix}{key}.")
        for key in [k for k in node if re.fullmatch(r"skip_\d+", k)]:
            self.child(node, key, prefix, self.dense)
        for key in [k for k in node if re.fullmatch(r"items_(down|up)_\d+", k)]:
            self.child(node, key, prefix, self.item_stack_nd)
        self.done(node, prefix)

    def xunet(self, node: dict, prefix: str) -> None:
        if "proj_out" in node:
            self.xunet_nd(node, prefix)
            return
        for key in ("out_gn_scale", "out_gn_bias", "out_kernel", "out_bias"):
            self.leaf(node, key, prefix)
        for key in [k for k in node if re.fullmatch(r"(down|up)_\d+", k)]:
            sub = node.pop(key)
            self.leaf(sub, "kernel", f"{prefix}{key}.")
            self.leaf(sub, "bias", f"{prefix}{key}.")
            self.done(sub, f"{prefix}{key}.")
        for key in [k for k in node if re.fullmatch(r"skip_\d+", k)]:
            sub = node.pop(key)
            if "Dense_0" in sub:  # SkipModulate's gate
                self.child(sub, "Dense_0", f"{prefix}{key}.", self.dense)
            else:  # SkipCat
                self.leaf(sub, "kernel", f"{prefix}{key}.")
                self.leaf(sub, "bias", f"{prefix}{key}.")
            self.done(sub, f"{prefix}{key}.")
        for key in [k for k in node if re.fullmatch(r"items_(down|up)_\d+", k)]:
            self.child(node, key, prefix, self.item_stack)
        self.done(node, prefix)

    def kernel_and_bias(self, node: dict, prefix: str) -> None:
        """A conv, patch or norm layer: its ``kernel`` or ``scale``, and its
        ``bias`` if it has one."""
        self.leaf(node, "scale" if "scale" in node else "kernel", prefix)
        if "bias" in node:
            self.leaf(node, "bias", prefix)
        self.done(node, prefix)

    def net(self, node: dict, prefix: str = "") -> None:
        """The XUNet inside any of its wrappers."""
        if "sigma_embedding" in node:  # time conditioning
            where = prefix + "sigma_embedding."
            se = self.take(node, "sigma_embedding", prefix)
            self.leaf(se, "freqs", where)
            self.child(se, "Dense_0", where, self.dense)
            self.child(se, "Dense_1", where, self.dense)
            self.done(se, where)
        elif "fixed_embedding" in node:  # classifier-free guidance
            self.leaf(node, "fixed_embedding", prefix)
        elif "encode" in node or "decode" in node:  # LTPlugin
            for key in ("encode", "decode"):
                self.child(node, key, prefix, self.kernel_and_bias)
        elif set(node) != {"inner"}:  # not AppendChannelsPlugin's wrapper
            self.xunet(node, prefix)
            return
        self.child(node, "inner", prefix, self.net)
        self.done(node, prefix)

    def mel_encoder(self, node: dict, prefix: str) -> None:
        """``MelEncoder1d``'s flax tree."""
        for key in [k for k in node if re.fullmatch(r"ResnetItem_\d+", k)]:
            self.child(node, key, prefix, self.resnet_item)
        for key in [k for k in node if re.fullmatch(
                r"(Conv1d|Downsample|GroupNorm)_\d+", k)]:
            self.child(node, key, prefix, self.kernel_and_bias)
        self.done(node, prefix)

    def task(self, tree: dict) -> None:
        """A task model's whole tree, or a net's alone."""
        if "net" not in tree:
            self.net(tree)
            return
        self.net(self.take(tree, "net", ""))
        for key, fn in (("encoder", self.mel_encoder),
                        ("to_flat", self.kernel_and_bias)):
            if key in tree:
                node = self.take(tree, key, "")
                node = node["params"] if set(node) == {"params"} else node
                fn(node, f"{key}/")
        self.done(tree, "")


def _plain(tree) -> dict:
    """Nested mappings -> a mutable copy of nested dicts."""
    if isinstance(tree, Mapping):
        return {str(k): _plain(v) for k, v in tree.items()}
    return tree


def _layout(tree: Mapping, caller: str) -> Dict[str, tuple]:
    walk = _Walk(caller)
    walk.task(_plain(tree))
    return walk.out


def _is_qtensor(a) -> bool:
    return all(hasattr(a, k) for k in ("q", "qscale", "bits", "orig_dtype"))


def _qtensor_from_jax(a, is_dense: bool) -> QTensor:
    q = np.array(a.q, dtype=np.int8)
    s = np.array(a.qscale, dtype=np.float32)
    shape = a.orig_shape
    if is_dense:
        q, s = q.T.copy(), s.T.copy()
        shape = None if shape is None else tuple(shape)[::-1]
    return QTensor(torch.from_numpy(q), torch.from_numpy(s),
                   str(a.orig_dtype), int(a.bits), shape,
                   0 if is_dense else -1)


def params_from_jax(tree: Mapping) -> Dict[str, Tensor]:
    """JAX ``UNetV0`` parameter tree -> the port's state_dict (f32 CPU
    tensors; a JAX ``QTensor`` leaf -> the port's ``QTensor``); a task
    model's whole tree -> its ``params``."""
    out = {}
    for name, (a, is_dense) in _layout(tree, "params_from_jax").items():
        if _is_qtensor(a):
            out[name] = _qtensor_from_jax(a, is_dense)
            continue
        a = np.array(a, dtype=np.float32)
        out[name] = torch.from_numpy(a.T.copy() if is_dense else a)
    return out


def _qtensor_to_jax(t: QTensor, is_dense: bool, qtensor):
    q = t.q.detach().cpu().numpy()
    s = t.qscale.detach().to("cpu", torch.float32).numpy()
    shape = t.orig_shape
    if is_dense:
        q, s = q.T.copy(), s.T.copy()
        shape = None if shape is None else shape[::-1]
    return qtensor(q, s, t.orig_dtype, t.bits, shape)


def params_to_jax(state: Mapping[str, Tensor], qtensor=QTensor) -> dict:
    """The port's state_dict (or ``model.params``) -> the JAX ``UNetV0``
    parameter tree, as nested dicts of float32 numpy arrays. A task model's
    ``params`` with extras give the model's whole tree (``{"net": ...,
    "encoder": {"params": ...}}``); the JAX model of a task without extras
    holds ``{"net": params_to_jax(params)}``. A ``QTensor`` becomes
    ``qtensor(q, qscale, orig_dtype, bits, orig_shape)`` of numpy arrays in
    the JAX layout."""
    net: dict = {}
    extras: dict = {}
    for name, t in state.items():
        extra, _, name = name.rpartition("/")
        *path, key = name.split(".")
        dense = key == "weight"  # an nn.Linear: the flax kernel is [in, out]
        if isinstance(t, QTensor):
            leaf = _qtensor_to_jax(t, dense, qtensor)
        else:
            a = t.detach().to("cpu", torch.float32).numpy()
            leaf = np.array(a.T if dense else a, dtype=np.float32)
        if dense:
            key = "kernel"
        node = (extras.setdefault(extra, {}).setdefault("params", {})
                if extra else net)
        for part in path:
            node = node.setdefault(part, {})
        node[key] = leaf
    tree = {"net": net, **extras} if extras else net
    # The tree must be one that params_from_jax reads back name for name.
    names = set(_layout(tree, "params_to_jax"))
    if names != set(state):
        raise ValueError(f"params_to_jax: {sorted(set(state) ^ names)} "
                         "do not map onto the JAX tree")
    return tree


def _optax_states(node, found: list) -> None:
    """Collect optax's named states (tuples with ``_fields``) in a chain's
    state, depth first."""
    if hasattr(node, "_fields"):
        found.append(node)
    elif isinstance(node, (tuple, list)):
        for child in node:
            _optax_states(child, found)
    else:
        raise ValueError(f"train_state_from_jax: unexpected optimizer state "
                         f"{type(node).__name__}")


def train_state_from_jax(state) -> dict:
    """JAX ``TrainState`` of an optax Adam(W) chain -> the content of
    ``Trainer.load_state_dict`` (see the module docstring)."""
    get = (state.get if isinstance(state, Mapping)
           else lambda k: getattr(state, k))
    found: list = []
    _optax_states(get("opt_state"), found)
    adam = [s for s in found if set(s._fields) == {"count", "mu", "nu"}]
    other = [s for s in found if s._fields not in ((), ("count",))
             and all(s is not a for a in adam)]
    if len(adam) != 1 or other:
        raise ValueError(
            "train_state_from_jax: needs exactly one ScaleByAdamState and "
            "no other state with arrays; found "
            f"{[type(s).__name__ for s in found]}")
    adam = adam[0]
    count = int(np.asarray(adam.count))
    for s in found:
        if s._fields == ("count",) and int(np.asarray(s.count)) != count:
            raise ValueError("train_state_from_jax: the schedule's count "
                             f"{int(np.asarray(s.count))} is not Adam's "
                             f"{count}")
    params = params_from_jax(get("params"))
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    ema = get("ema")
    return {
        "step": int(np.asarray(get("step"))),
        "params": params,
        "optimizer": {name: {"step": torch.tensor(float(count)),
                             "exp_avg": mu[name], "exp_avg_sq": nu[name]}
                      for name in params},
        "generator": None,
        "ema": None if ema is None else params_from_jax(ema),
    }


def _t5_block(walk: _Walk, node: dict, prefix: str, first: bool) -> None:
    layers = walk.take(node, "layer", prefix)
    where = prefix + "layer."
    attn = walk.take(layers, "0", where)
    sa = walk.take(attn, "SelfAttention", where + "0.")
    for key in ("q", "k", "v", "o"):
        walk.child(sa, key, where + "0.SelfAttention.", walk.dense)
    if first:
        bias = walk.take(sa, "relative_attention_bias",
                         where + "0.SelfAttention.")
        walk.out[where + "0.SelfAttention.relative_attention_bias.weight"] = (
            walk.take(bias, "embedding", where), False)
        walk.done(bias, where + "0.SelfAttention.relative_attention_bias.")
    walk.done(sa, where + "0.SelfAttention.")
    _t5_norm(walk, attn, "layer_norm", where + "0.")
    walk.done(attn, where + "0.")
    ff = walk.take(layers, "1", where)
    dense = walk.take(ff, "DenseReluDense", where + "1.")
    for key in ("wi", "wo"):
        walk.child(dense, key, where + "1.DenseReluDense.", walk.dense)
    walk.done(dense, where + "1.DenseReluDense.")
    _t5_norm(walk, ff, "layer_norm", where + "1.")
    walk.done(ff, where + "1.")
    walk.done(layers, where)
    walk.done(node, prefix)


def _t5_norm(walk: _Walk, node: dict, key: str, prefix: str) -> None:
    norm = walk.take(node, key, prefix)
    walk.leaf(norm, "weight", f"{prefix}{key}.")
    walk.done(norm, f"{prefix}{key}.")


def t5_params_from_flax(params: Mapping) -> Dict[str, Tensor]:
    """Flax T5 encoder parameter tree (nested mappings of arrays, with or
    without the outer ``{"params": ...}``) -> the state_dict of
    ``ops.t5.T5EncoderStack`` (f32 CPU tensors). Dense kernels [in, out]
    become ``nn.Linear`` weights [out, in]; embeddings keep their layout.
    Block 0 must hold the relative-position bias and no other block may.
    Strict: a leftover or a missing leaf raises."""
    tree = _plain(params)
    if set(tree) == {"params"}:
        tree = tree["params"]
    walk = _Walk("t5_params_from_flax")
    shared = walk.take(tree, "shared", "")
    walk.out["shared.weight"] = (walk.take(shared, "embedding", "shared."),
                                 False)
    walk.done(shared, "shared.")
    encoder = walk.take(tree, "encoder", "")
    blocks = walk.take(encoder, "block", "encoder.")
    for i in range(len(blocks)):
        walk.child(blocks, str(i), "encoder.block.",
                   lambda node, prefix, first=(i == 0):
                   _t5_block(walk, node, prefix, first))
    walk.done(blocks, "encoder.block.")
    _t5_norm(walk, encoder, "final_layer_norm", "encoder.")
    walk.done(encoder, "encoder.")
    walk.done(tree, "")
    out = {}
    for name, (a, is_dense) in walk.out.items():
        a = np.array(a, dtype=np.float32)
        out[name] = torch.from_numpy(a.T.copy() if is_dense else a)
    return out


# Flax kernel -> torch weight permutation by layer kind (and back, argsort).
_EMBEDDER_KERNELS = {"Conv": (2, 1, 0), "Dense": (1, 0)}


def _embedder_kind(name: str) -> str:
    kind = name.split("_")[0]
    if kind not in _EMBEDDER_KERNELS:
        raise ValueError(f"embedder params: unexpected layer {name!r}")
    return kind


def embedder_params_from_flax(params: Mapping) -> Dict[str, Tensor]:
    """The JAX ``CorpusEmbedder``'s parameter tree (with or without the
    outer ``{"params": ...}``) -> the port embedder's parameters (f32 CPU
    tensors named ``"<layer>.weight"``/``"<layer>.bias"``). Strict: a
    leftover or a missing leaf raises."""
    tree = _plain(params)
    if set(tree) == {"params"}:
        tree = tree["params"]
    walk = _Walk("embedder_params_from_flax")
    out = {}
    for layer in sorted(tree):
        node = walk.take(tree, layer, "")
        perm = _EMBEDDER_KERNELS[_embedder_kind(layer)]
        kernel = np.array(walk.take(node, "kernel", layer), np.float32)
        out[f"{layer}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(perm)))
        if "bias" in node:
            out[f"{layer}.bias"] = torch.from_numpy(np.array(
                walk.take(node, "bias", layer), np.float32))
        walk.done(node, f"{layer}.")
    walk.done(tree, "")
    return out


def embedder_params_to_flax(params: Mapping[str, Tensor]) -> dict:
    """The port embedder's parameters -> the JAX ``CorpusEmbedder``'s tree
    ``{"params": ...}`` of float32 numpy arrays. Strict: a name other than
    ``"<layer>.weight"``/``"<layer>.bias"``, or a layer without its
    weight, raises."""
    tree: Dict[str, dict] = {}
    for name, t in params.items():
        layer, _, leaf = name.partition(".")
        a = t.detach().float().cpu().numpy()
        if leaf == "weight":
            perm = np.argsort(_EMBEDDER_KERNELS[_embedder_kind(layer)])
            tree.setdefault(layer, {})["kernel"] = np.ascontiguousarray(
                a.transpose(perm))
        elif leaf == "bias":
            tree.setdefault(layer, {})["bias"] = a
        else:
            raise ValueError(f"embedder_params_to_flax: unexpected {name!r}")
    missing = sorted(k for k, node in tree.items() if "kernel" not in node)
    if missing:
        raise ValueError(f"embedder_params_to_flax: no weight for {missing}")
    return {"params": tree}
