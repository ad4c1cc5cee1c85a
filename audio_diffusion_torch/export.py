"""Sampler export: a deployable serving artifact (counterpart of
audio_diffusion_tpu/export.py, through ``torch.export`` in place of
``jax.export``).

A serving host runs the artifact with the parameter file alone::

    sampler, manifest = load_sampler("artifact/")
    audio = sampler(load_params("run/model"), noise)

What is exported is ONE sampler step, traced by ``torch.export`` with
``strict=False``: ``step(params, carry, row, arrays) -> carry``, the net's
forward and the sampler's update. The loop runs in :func:`load_sampler`
over the per-step coefficient table that the manifest holds, as the live
sampler computed it on the exporting device. With ``encoder_reuse=k`` two
step forms are traced: the full step, which also returns the net's encoder
state (``step.pt2``), and the reuse step, which decodes that state
(``reuse.pt2``); the loop runs them in chunks of k steps, as
``VSampler(encoder_reuse=k)`` does. A trace of the whole loop
would hold every step's nodes (50 x 42 items and the rest at the flagship)
and take that many times as long to export, save and load (``PERF.md``).
``VSampler.sample`` and ``DPMSampler.sample`` run the very same steps
(``diffusion/samplers.py``), so the artifact's output equals
``model.sample``'s bit for bit, on the CPU and on the card.

- Parameters are an INPUT of the program, never baked in: one artifact
  serves every checkpoint of the configuration. A quantized dict
  (``ops/quant.py``) exports as such: its QTensors are inputs and the
  program dequantizes them inside the step.
- Scalar conditioning (e.g. ``embedding_scale``) is baked in; array
  conditioning (``embedding=``) is an input, passed per call.
- Shapes, the step count, the sampler and the device type are fixed at
  export. Loading fails loudly on another device type, on a JAX artifact,
  and on a mismatched shape or step count.

Loading needs the registered operator of the fused resnet item (the
program calls ``torch.ops.audio_diffusion_torch.fused_resnet_item`` on the
card), so this module imports ``ops.kernels.resnet``: the operator library,
not the net's definition. It casts the parameters to the compute dtype
with ``ops.net.cast_inference_params``, once per sample, as the live
sampler does. Not AOTInductor: its compiled kernels would not be the
port's, and the artifact must give the live model's bits.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import Tensor, nn

from .diffusion.samplers import _check_reuse, reuse_kwargs
from .ops.kernels import resnet as _resnet  # noqa: F401  (the operator)
from .ops.net import cast_inference_params
from .ops.quant import dequantize_step_params
from .utils import resolve_device

__all__ = ["export_sampler", "load_sampler", "load_params",
           "ArtifactSampler"]

KIND = "audio_diffusion_torch.sampler"
_JAX_KIND = "audio_diffusion_tpu.sampler"
_PROGRAM_NAME = "step.pt2"
_REUSE_PROGRAM_NAME = "reuse.pt2"
_MANIFEST_NAME = "manifest.json"


class _Step(nn.Module):
    """One sampler step as a module for ``torch.export``. The model is held
    in a tuple, outside the module tree, so none of its parameters is
    lifted into the program."""

    def __init__(self, model, cond: Dict, return_hidden: bool = False):
        super().__init__()
        self._held = (model, cond, return_hidden)

    def forward(self, params, carry, row, arrays, hidden=None):
        """The step; with ``return_hidden``, (carry, the encoder state);
        with ``hidden``, the reuse step decoding that state."""
        model, cond, return_hidden = self._held
        net = model.net
        call = functools.partial(
            net.apply, dequantize_step_params(params, net.compute_dtype))
        extra = ({"return_hidden": True} if return_hidden
                 else {} if hidden is None else {"hidden": hidden})
        return model.sampler.step(call, tuple(carry), row, **extra, **cond,
                                  **arrays)


def _export_step(module: nn.Module, args: Tuple):
    """``torch.export`` of one step form, pruned; (program, nodes pruned).
    The example inputs hold the parameters: they are kept out of the
    file."""
    program = torch.export.export(module, args, strict=False)
    program.example_inputs = None
    return program, _prune(program)


def _prune(program) -> int:
    """Drop what a step needs no node for, in place: the tensor-metadata
    assertions that export puts before each cast, and casts to the dtype a
    tensor already has (``aten.to`` returns its input then). Each is a
    Python call per step in the loaded program; eager code makes neither.
    Returns the nodes removed."""
    graph, removed = program.graph, 0
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
            removed += 1
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2
              and not node.kwargs
              and node.args[0].meta["val"].dtype == node.args[1]
              and all(user.op != "output" for user in node.users)):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
            removed += 1
    program.graph_module.recompile()
    return removed


def _dtype_name(dtype) -> Optional[str]:
    return None if dtype is None else str(dtype).split(".")[-1]


def export_sampler(model, path, *, length: int, batch_size: int = 1,
                   num_steps: int = 50, channels: Optional[int] = None,
                   params: Optional[Dict] = None,
                   sample_rate: Optional[int] = None, **cond) -> Dict:
    """Export the model's sampler for ``(batch_size, channels, length)``
    float32 noise at ``num_steps`` steps to ``path/`` (``step.pt2`` and
    ``manifest.json``), on the model's device. Returns the manifest.

    ``params=`` (default: the live parameters) sets only the shapes,
    dtypes and quantization the program takes. ``**cond`` scalars are
    baked in; ``**cond`` arrays (example arrays of the per-call shape)
    become inputs of the program. ``encoder_reuse=k`` (k > 1, dividing
    ``num_steps``) exports the full and the reuse step; the manifest
    records k and the loaded sampler replays the chunks."""
    sampler = model.sampler
    if not all(hasattr(sampler, a) for a in ("coefficients", "start",
                                             "step")):
        raise ValueError(
            f"export traces one step of a VSampler or DPMSampler; "
            f"{type(sampler).__name__} has no step form")
    reuse = int(cond.pop("encoder_reuse", 1))
    _check_reuse(num_steps, reuse)
    p = model.split_params(params if params is not None else model.params)[0]
    device = model.device
    arrays: Dict[str, Tensor] = {}
    scalars = {}
    for k, v in cond.items():
        if hasattr(v, "shape") and len(v.shape) > 0:
            arrays[k] = torch.as_tensor(v, device=device)
        else:
            # 0-dim numpy or torch scalars -> Python scalars, for the JSON
            # manifest.
            scalars[k] = v.item() if hasattr(v, "item") else v
    c = channels if channels is not None else getattr(
        model.net, "in_channels", None)
    assert c is not None, "pass channels= (net does not declare in_channels)"

    dtype = model.net.compute_dtype
    with torch.no_grad():
        example = cast_inference_params(
            {k: v.detach() if isinstance(v, Tensor) else v
             for k, v in p.items()}, dtype)
        noise = torch.zeros(batch_size, c, length, device=device)
        carry = sampler.start(noise)
        table = sampler.coefficients(num_steps, device)
        row = {k: t[0] for k, t in table.items()}
        args = (example, carry, row, arrays)
        full = _Step(model, scalars, return_hidden=reuse > 1)
        program, pruned = _export_step(full, args)
        programs = {_PROGRAM_NAME: program}
        if reuse > 1:
            # The reuse step's example encoder state: one eager full step
            # on the example inputs.
            _, hidden = full(*args)
            programs[_REUSE_PROGRAM_NAME], pruned_reuse = _export_step(
                _Step(model, scalars), args + (hidden,))
            pruned += pruned_reuse
    out = [n for n in program.graph.nodes if n.op == "output"][0]
    out_val = out.args[0][0].meta["val"]

    manifest = {
        "kind": KIND,
        "noise_shape": [batch_size, c, length],
        "num_steps": num_steps,
        # The JAX artifact's scan unroll; one step is traced here.
        "unroll": 1,
        "encoder_reuse": reuse,
        "platforms": [device.type],
        "sample_rate": (int(sample_rate) if sample_rate is not None
                        else None),
        "scalar_cond": dict(scalars),
        "array_cond": {k: {"shape": list(a.shape),
                           "dtype": _dtype_name(a.dtype)}
                       for k, a in arrays.items()},
        "torch_version": torch.__version__,
        "out_shape": list(out_val.shape),
        "out_dtype": _dtype_name(out_val.dtype),
        "sampler": type(sampler).__name__,
        "carry": len(carry),
        "compute_dtype": _dtype_name(dtype),
        "graph_nodes": sum(len(p.graph.nodes) for p in programs.values()),
        "pruned_nodes": pruned,
        "param_names": list(p),
        # The live sampler's table, as it computed it on this device: the
        # f32 values are exact in JSON's doubles.
        "coefficients": {k: t.cpu().tolist() for k, t in table.items()},
    }
    # Serialize the manifest first: a failure must not leave a program
    # without a manifest behind.
    manifest_text = json.dumps(manifest, indent=1)
    dest = Path(path)
    dest.mkdir(parents=True, exist_ok=True)
    for name, prog in programs.items():
        torch.export.save(prog, dest / name)
    (dest / _MANIFEST_NAME).write_text(manifest_text)
    return manifest


def _read_manifest(src: Path) -> Dict:
    manifest = json.loads((src / _MANIFEST_NAME).read_text())
    kind = manifest.get("kind")
    if kind == _JAX_KIND:
        raise ValueError(
            f"{src} is an artifact of the JAX package ({_JAX_KIND}, a "
            "StableHLO program); export the model with "
            "audio_diffusion_torch.export_sampler")
    if kind != KIND:
        raise ValueError(f"{src} is not an exported sampler artifact")
    return manifest


def load_sampler(path, device=None) -> Tuple[Callable, Dict]:
    """Load an exported sampler: ``(sampler, manifest)``, where
    ``sampler(params, noise, **array_cond)`` runs the loop of the exported
    step under ``torch.inference_mode``. ``device`` defaults to the
    exporting device type (the card: ``cuda``); another type raises.
    ``params`` must hold the exporting configuration's names (a
    ``DiffusionModel.save`` file through :func:`load_params`); ``noise``
    must have the manifest's shape; every ``array_cond`` of the manifest is
    required by keyword."""
    src = Path(path)
    manifest = _read_manifest(src)
    platform = manifest["platforms"][0]
    device = torch.device(device if device is not None else platform)
    if device.type != platform:
        raise ValueError(f"{src} was exported for {platform}; it does not "
                         f"run on {device.type}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{src} was exported for cuda; no CUDA device is "
                           "available")
    reuse = int(manifest.get("encoder_reuse", 1))
    # Each program's first step of a sample checks every input's shape and
    # dtype against the program; the same inputs then skip that check.
    names = [_PROGRAM_NAME] + ([_REUSE_PROGRAM_NAME] if reuse > 1 else [])
    checked, fast = {}, {}
    for name in names:
        program = torch.export.load(src / name)
        checked[name], fast[name] = program.module(), program.module()
        fast[name]._forward_pre_hooks.clear()
    table = {k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in manifest["coefficients"].items()}
    need = sorted(manifest.get("array_cond") or {})
    param_names = manifest["param_names"]
    shape = tuple(manifest["noise_shape"])
    dtype = manifest["compute_dtype"]
    dtype = None if dtype is None else getattr(torch, dtype)

    def sampler(params, noise, **arrays):
        if sorted(arrays) != need:
            raise ValueError(f"artifact requires array conditioning {need}, "
                             f"got {sorted(arrays)}")
        if set(params) != set(param_names):
            raise ValueError(
                "params do not match the exported configuration: "
                f"{sorted(set(params) ^ set(param_names))[:8]}")
        if tuple(noise.shape) != shape:
            raise ValueError(f"artifact expects noise {shape}, got "
                             f"{tuple(noise.shape)}")
        with torch.inference_mode():
            p = cast_inference_params({n: params[n] for n in param_names},
                                      dtype)
            noise = torch.as_tensor(noise, device=device)
            carry = (noise,) + tuple(torch.zeros_like(noise)
                                     for _ in range(manifest["carry"] - 1))
            arrays = {k: torch.as_tensor(arrays[k], device=device)
                      for k in need}
            enc, ran = None, set()
            for i in range(manifest["num_steps"]):
                extra = reuse_kwargs(i, reuse, enc)
                name = _REUSE_PROGRAM_NAME if "hidden" in extra \
                    else _PROGRAM_NAME
                step = fast[name] if name in ran else checked[name]
                ran.add(name)
                hidden = (enc,) if "hidden" in extra else ()
                carry = step(p, carry, {c: t[i] for c, t in table.items()},
                             arrays, *hidden)
                if "return_hidden" in extra:
                    carry, enc = carry
            return carry[0]

    return sampler, manifest


def load_params(path, device=None) -> Dict[str, Tensor]:
    """The parameters that ``DiffusionModel.save`` wrote, without building
    a model (``torch.load`` with ``weights_only=True``), on ``device``
    (default: the card). Pairs with :func:`load_sampler`."""
    return torch.load(path, map_location=resolve_device(device),
                      weights_only=True)


class ArtifactSampler:
    """Model-shaped wrapper over an exported artifact: a drop-in for
    :class:`~audio_diffusion_torch.serve.GenerationService`'s ``model`` (and
    the HTTP server above it), so a serving host deploys from the artifact
    and the parameter file alone::

        sampler = ArtifactSampler("artifact/", load_params("run/model"))
        service = GenerationService(sampler, num_steps=sampler.num_steps,
                                    batch_size=sampler.batch_size,
                                    result_format="pcm16")

    The artifact fixes the shapes and the step count; ``sample`` enforces
    them: a mismatched request fails loudly."""

    def __init__(self, path, params: Optional[Dict] = None, device=None):
        self._fn, self.manifest = load_sampler(path, device)
        self.device = torch.device(device if device is not None
                                   else self.manifest["platforms"][0])
        self.params = params
        self.num_steps = int(self.manifest["num_steps"])
        self.encoder_reuse = int(self.manifest.get("encoder_reuse", 1))
        b, c, t = self.manifest["noise_shape"]
        self.batch_size, self.in_channels, self.length = b, c, t
        self.sample_rate = self.manifest.get("sample_rate")
        self.array_cond = dict(self.manifest.get("array_cond") or {})

    def sample(self, noise, *, num_steps: Optional[int] = None,
               params: Optional[Dict] = None,
               encoder_reuse: Optional[int] = None, **cond) -> Tensor:
        for name, asked, fixed in (
                ("num_steps", num_steps, self.num_steps),
                ("encoder_reuse", encoder_reuse, self.encoder_reuse)):
            if asked is not None and asked != fixed:
                raise ValueError(
                    f"artifact was exported at {name}={fixed}; per-request "
                    f"{name}={asked} needs its own artifact")
        extra = set(cond) - set(self.array_cond)
        if extra:
            raise ValueError(
                f"conditioning {sorted(extra)} cannot be passed to this "
                "artifact (scalars are baked at export time; the manifest "
                f"declares array inputs {sorted(self.array_cond)})")
        p = params if params is not None else self.params
        assert p is not None, "pass params= (or set .params) before sampling"
        noise = torch.as_tensor(noise, device=self.device)
        for k, spec in self.array_cond.items():
            if k not in cond:
                raise ValueError(f"artifact requires {k}= "
                                 f"(shape {spec['shape']})")
            got = tuple(cond[k].shape)
            if got != tuple(spec["shape"]):
                raise ValueError(
                    f"{k} shape {got} != exported {tuple(spec['shape'])}")
        return self._fn(p, noise, **cond)
