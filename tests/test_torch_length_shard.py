"""Length-sharded sampling (audio_diffusion_torch.parallel.
sample_length_sharded) and the sharded fused item's plain version on the
CPU, over two gloo ranks spawned as in tests/test_torch_parallel.py (this
file runs as the worker), on the 3-level TINY of tests/test_parallel.py at
256 samples, float32, with a seeded JAX tree's weights.

Tolerances.
- A 3-step VSampler and DPMSampler sample, sharded over two ranks, vs the
  unsharded port sample and vs the JAX package's sample_length_sharded
  over its 8 virtual CPU devices: atol = rtol = 2e-4, the bar of
  tests/test_parallel.py:117-120.
- The sharded plain item's GroupNorm statistics vs the unsharded ones over
  the same tiles (shards a multiple of the 8192 // C rows of a tile): bit
  for bit; the sharded plain item vs ``resnet_item_reference``: 1e-5.
- A data-sharded batch sample (each rank samples its rows) vs the
  unsharded sample: atol = rtol = 2e-4.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from audio_diffusion_torch import (DiffusionModel, DPMSampler, SDESampler,
                                   UNetV0)
from audio_diffusion_torch.ops.kernels.resnet import (
    fused_resnet_item, gn_finalize_reference, gn_partials_reference,
    resnet_item_reference, resnet_item_sharded_reference)
from audio_diffusion_torch.parallel import (comm, create_mesh,
                                            sample_length_sharded,
                                            shard_batch)
from test_torch_parallel import join_group, one_rank_mesh, spawn

torch.set_num_threads(2)

TINY = dict(in_channels=2, channels=[8, 32, 256], factors=[1, 4, 2],
            items=[1, 1, 1], attentions=[0, 0, 1], attention_heads=4,
            attention_features=8, modulation_features=64)
LENGTH = 256
STEPS = 3
ITEM_L, ITEM_C = 128, 256  # 32 rows per statistics tile: 2 tiles per rank


def port_model(params, sampler_t=None) -> DiffusionModel:
    kw = dict(sampler_t=sampler_t) if sampler_t is not None else {}
    model = DiffusionModel(net_t=UNetV0, device="cpu", **TINY, **kw)
    model.net.module.load_state_dict(params, strict=True)
    return model


def item_inputs(seed: int = 0):
    """An item at [1, ITEM_L, ITEM_C] with random parameters."""
    g = torch.Generator().manual_seed(seed)
    c = ITEM_C

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    x = r(1, ITEM_L, c)
    params = (1 + r(c, scale=0.1), r(c, scale=0.1), r(3, c, c, scale=0.03),
              r(c, scale=0.1), 1 + r(c, scale=0.1), r(c, scale=0.1),
              r(3, c, c, scale=0.03), r(c, scale=0.1), r(1, c, scale=0.1),
              r(1, c, scale=0.1), 1 + r(c, scale=0.1), r(c, scale=0.1))
    return x, params


def worker(rank: int, port: int, root: Path) -> None:
    join_group(rank, port)
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    mesh = create_mesh("cpu")
    group = mesh.get_group("data")
    out = {}
    for name, sampler_t in (("v", None), ("dpm", DPMSampler)):
        model = port_model(inputs["params"], sampler_t)
        out[name] = sample_length_sharded(model, inputs["noise"], STEPS,
                                          mesh)
        out[name + "_gathered"] = sample_length_sharded(
            model, inputs["noise"], STEPS, mesh, gather=True)
    model = port_model(inputs["params"])
    out["dp_sample"] = model.sample(shard_batch(inputs["batch_noise"], mesh),
                                    num_steps=STEPS)

    x, params = item_inputs()
    part = ITEM_L // 2
    local = x[:, rank * part:(rank + 1) * part]
    every = comm.all_gather_rows(gn_partials_reference(local, 8), group,
                                 dim=1)
    out["stats"] = gn_finalize_reference(every, ITEM_L, ITEM_C, 1e-5)
    shard = comm.group_shard(group)
    out["item"] = resnet_item_sharded_reference(local, *params, shard=shard)
    try:
        with comm.length_shard(group):
            fused_resnet_item(local.clone().requires_grad_(True), *params)
        out["grad_refusal"] = None
    except NotImplementedError as e:
        out["grad_refusal"] = str(e)
    torch.save(out, root / f"rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from audio_diffusion_torch import params_from_jax
    from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
    from audio_diffusion_tpu import UNetV0 as JaxUNetV0
    from audio_diffusion_tpu.parallel import create_mesh as jax_mesh
    from audio_diffusion_tpu.parallel import sample_length_sharded as jax_sls

    root = tmp_path_factory.mktemp("length_shard")
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((1, 2, LENGTH)).astype(np.float32)
    batch_noise = rng.standard_normal((2, 2, LENGTH)).astype(np.float32)
    jmodel = JaxDiffusionModel(net_t=JaxUNetV0, seed=0, **TINY)
    jmodel.initialize(jnp.asarray(noise))
    rs = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.randn(*a.shape)).astype(
            np.float32), jmodel.params["net"])
    jmodel.params = {"net": tree}
    params = params_from_jax(tree)
    torch.save(dict(params=params, noise=torch.from_numpy(noise),
                    batch_noise=torch.from_numpy(batch_noise)),
               root / "inputs.pt")
    ranks = spawn(Path(__file__), root)
    jax_out = np.asarray(jax_sls(jmodel, jnp.asarray(noise), STEPS,
                                 jax_mesh()))
    return params, noise, batch_noise, ranks, jax_out


@pytest.mark.parametrize("name", ["v", "dpm"])
def test_length_sharded_sample_matches_unsharded(sharded, name):
    params, noise, _, ranks, jax_out = sharded
    model = port_model(params, DPMSampler if name == "dpm" else None)
    want = model.sample(torch.from_numpy(noise), num_steps=STEPS)
    got = torch.cat([r[name] for r in ranks], dim=-1)
    assert [r[name].shape[-1] for r in ranks] == [LENGTH // 2] * 2
    for r in ranks:
        assert torch.equal(r[name + "_gathered"], got)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    if name == "v":
        np.testing.assert_allclose(got.numpy(), jax_out, atol=2e-4,
                                   rtol=2e-4)


def test_data_sharded_batch_sample_concatenates_to_unsharded(sharded):
    params, _, batch_noise, ranks, _ = sharded
    want = port_model(params).sample(torch.from_numpy(batch_noise),
                                     num_steps=STEPS)
    got = torch.cat([r["dp_sample"] for r in ranks])
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def test_sharded_plain_item_statistics_are_the_unsharded_bits(sharded):
    ranks = sharded[3]
    x, params = item_inputs()
    want = gn_finalize_reference(gn_partials_reference(x, 8), ITEM_L, ITEM_C,
                                 1e-5)
    for r in ranks:
        assert torch.equal(r["stats"], want)
    got = torch.cat([r["item"] for r in ranks], dim=1)
    torch.testing.assert_close(got, resnet_item_reference(x, *params),
                               atol=1e-5, rtol=0)


def test_length_sharded_refusals():
    cfg = dict(in_channels=1, channels=[8, 16], factors=[1, 2], items=[1, 1],
               modulation_features=32)
    noise = torch.zeros(1, 1, 256)
    with one_rank_mesh() as mesh:
        keyed = DiffusionModel(net_t=UNetV0, sampler_t=SDESampler,
                               device="cpu", **cfg)
        with pytest.raises(NotImplementedError,
                           match="consumes RNG and takes no noise input"):
            sample_length_sharded(keyed, noise, 2, mesh)
        model = DiffusionModel(net_t=UNetV0, device="cpu", **cfg)
        with pytest.raises(AssertionError, match="no key"):
            sample_length_sharded(model, noise, 2, mesh,
                                  key=torch.Generator())
        with pytest.raises(ValueError, match="not divisible"):
            sample_length_sharded(model, torch.zeros(1, 1, 255), 2, mesh)
        with pytest.raises(TypeError, match="DeviceMesh"):
            sample_length_sharded(model, noise, 2, object())


def test_length_sharded_item_takes_no_gradient(sharded):
    for r in sharded[3]:
        assert "takes no gradient" in r["grad_refusal"]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
