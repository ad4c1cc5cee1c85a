"""Device mesh and sharding rules (counterpart of
audio_diffusion_tpu/parallel/mesh.py) on ``torch.distributed``.

The JAX package runs one controller over global arrays; here one process
runs per rank and holds its part. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the dims
``("data", "model")``:

- ``data``: batch-sharded data parallelism, the workhorse at these model
  sizes;
- ``model``: wide parameters stored as shards of their output-feature axis
  (:func:`param_sharding_rules`). The README-scale U-Nets do not need it;
  the axis exists so the same train step can hold state past one card's
  memory.

Collectives over either dim go through ``parallel/comm.py``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["create_mesh", "shard_batch", "shard_params",
           "param_sharding_rules", "global_batch"]

# Parameters at least this wide on their output-feature axis are considered
# for model sharding; small ones (biases, norm scales, narrow kernels)
# replicate.
_MIN_SHARD_WIDTH = 256
AXES = ("data", "model")


def _device_type(devices) -> str:
    """The rank's device type: ``None`` is the CUDA card, which must exist;
    else ``"cuda"``, ``"cpu"`` or a ``torch.device``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass devices='cpu' for CPU ranks")
        return "cuda"
    return torch.device(devices).type


def create_mesh(devices=None, data: Optional[int] = None, model: int = 1,
                backend: Optional[str] = None) -> DeviceMesh:
    """A 2-D ``("data", "model")`` mesh over the ranks of the default
    process group; ``data`` fills what ``model`` leaves.

    ``devices`` is the device type of this rank's part: the CUDA card by
    default, or ``"cpu"``. ``backend`` defaults to NCCL for CUDA ranks and
    gloo for CPU ranks; gloo on CUDA ranks (several ranks sharing one card,
    which NCCL refuses) is asked for by name. If no group exists, it is
    made: the launcher's (``torchrun`` sets ``WORLD_SIZE``; a CUDA rank
    takes card ``LOCAL_RANK % device_count`` first), else a one-rank group
    in this process on the current card. An existing group must run
    ``backend``. A failing init raises; nothing changes backend or device
    on its own."""
    device_type = _device_type(devices)
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            if device_type == "cuda":
                local = int(os.environ.get("LOCAL_RANK",
                                           os.environ.get("RANK", 0)))
                torch.cuda.set_device(local % torch.cuda.device_count())
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"the mesh asks for {backend}")
    n = dist.get_world_size()
    if data is None:
        assert n % model == 0, f"{n} devices not divisible by model={model}"
        data = n // model
    assert data * model == n, (
        f"data({data}) × model({model}) != devices({n})")
    ranks = np.arange(n).reshape(data, model)
    me = dist.get_rank()
    groups = {}
    # Every rank makes every group, in one order: the data groups (one per
    # model index), then the model groups (one per data index).
    for name, rows in (("data", ranks.T), ("model", ranks)):
        for members in rows:
            group = dist.new_group(members.tolist(), backend=backend)
            if me in members:
                groups[name] = group
    return DeviceMesh.from_group(
        [groups["data"], groups["model"]], device_type,
        mesh=torch.as_tensor(ranks), mesh_dim_names=AXES)


def check_mesh(mesh, what: str) -> None:
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{what} mesh= takes a torch.distributed DeviceMesh "
                        f"(create_mesh), got {type(mesh).__name__}")


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its current CUDA card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _tree_map(fn, tree):
    if isinstance(tree, (Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's rows of a global batch (a tensor, numpy array, or nested
    dicts, lists and tuples of them, each batch-leading) that every process
    holds, on this rank's device: the ``data`` index r of d takes rows
    ``r·B/d`` to ``(r + 1)·B/d``, and the ranks of one ``model`` group take
    the same rows. B must be divisible by d."""
    d, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    device = mesh_device(mesh)

    def rows(x):
        x = torch.as_tensor(x)
        if x.shape[0] % d:
            raise ValueError(f"a global batch of {x.shape[0]} rows does not "
                             f"split over data={d} ranks")
        n = x.shape[0] // d
        return x[r * n:(r + 1) * n].to(device)

    return _tree_map(rows, batch)


def global_batch(batch, mesh: DeviceMesh):
    """This rank's LOCAL batch (multi-process DP: each process loads its own
    disjoint shard through ``AudioDataset(num_hosts=...)``) as its part of
    the global batch, on this rank's device. The global batch size is
    ``local_batch × data``; the ``data`` index of the rank decides which
    global rows its part is."""
    device = mesh_device(mesh)
    return _tree_map(lambda x: torch.as_tensor(x).to(device), batch)


def output_axis(name: str, t: Tensor) -> int:
    """The output-feature axis of a port leaf: 0 for a Dense weight (an
    ``nn.Linear``, [out, in]), else the last (conv kernels keep the JAX
    layout [3, in, out])."""
    return 0 if name.rsplit(".", 1)[-1] == "weight" else t.ndim - 1


def param_sharding_rules(params, mesh: DeviceMesh):
    """A spec per parameter, keyed like ``params``: a leaf of two or more
    dims whose output-feature axis (:func:`output_axis`) is at least 256
    wide and divisible by the ``model`` size is sharded on that axis, as
    ``(None, ..., "model")`` (a Dense weight: ``("model", None)``);
    everything else replicates, ``()``. A ``model=1`` mesh replicates
    everything (pure DP)."""
    m = axis_size(mesh, "model")

    def rule(name, x):
        if x.ndim < 2:
            return ()
        ax = output_axis(name, x)
        if m > 1 and x.shape[ax] >= _MIN_SHARD_WIDTH and x.shape[ax] % m == 0:
            return tuple("model" if i == ax else None
                         for i in range(x.ndim))
        return ()

    return {name: rule(name, x) for name, x in params.items()}


def shard_params(params, mesh: DeviceMesh):
    """This rank's part of each parameter under
    :func:`param_sharding_rules`: its ``model`` index's slice of a sharded
    leaf, the whole of a replicated one, on this rank's device."""
    specs = param_sharding_rules(params, mesh)
    m, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    device = mesh_device(mesh)
    out = {}
    for name, x in params.items():
        x = x.detach().to(device)
        if specs[name]:
            ax = specs[name].index("model")
            w = x.shape[ax] // m
            x = x.narrow(ax, r * w, w).contiguous()
        out[name] = x
    return out
