"""The port's 3-D U-Net (``UNetV0(dim=3)``, ``ops/unet3d.py::XUNet3d``)
against the JAX package's on the config of tests/test_torch_unet2d.py with
8 x 16 x 16 volumes (cross-attention, context injection, modulation), the
same weights carried across by ``params_from_jax``.

Tolerances: float32 max-abs < 1e-3 and MSE < 1e-8 (measured max-abs
3.3e-6 at max|y| 2.9, MSE 2.4e-13); bfloat16 four ulps of max|y| and MSE
2e-4 (measured max-abs 0.047 at max|y| 3.45, three ulps, MSE 8.1e-5: the
rounding differences of tests/test_torch_unet2d.py); a 4-step
``encoder_reuse=2`` sample against the JAX model's, float32 MSE <= 1e-6
(the sample bar of test_parity_full_model.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_tpu.ops.net import cast_inference_params as jax_cast
from audio_diffusion_torch import (UNetV0, cast_inference_params,
                                   params_from_jax, params_to_jax)
from audio_diffusion_torch.ops.unet3d import XUNet3d
from test_torch_unet2d import (ND_CFG, bf16_ulps, jax_nd_net_and_tree,
                               nd_inputs, port_forward, port_nd_model, to_jax,
                               to_torch)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    net, cfg, tree = jax_nd_net_and_tree(3)
    return net, cfg, tree, port_nd_model(3, cfg, tree)


def test_forward_parity_f32(pair):
    net, cfg, tree, model = pair
    assert isinstance(model.net.module.inner, XUNet3d)
    x, sigmas, cond = nd_inputs(cfg, 3, 1)
    want = np.asarray(jax.jit(net.apply)(tree, jnp.asarray(x),
                                         jnp.asarray(sigmas), **to_jax(cond)))
    got = port_forward(model, x, sigmas, cond)
    assert got.shape == x.shape
    assert np.abs(got - want).max() < 1e-3
    assert np.mean((got - want) ** 2) < 1e-8


def test_forward_parity_bf16():
    net, cfg, tree = jax_nd_net_and_tree(3, seed=1, dtype=jnp.bfloat16)
    model = port_nd_model(3, ND_CFG, tree, dtype=torch.bfloat16)
    x, sigmas, cond = nd_inputs(cfg, 3, 3)
    want = np.asarray(jax.jit(net.apply)(
        jax_cast(tree, jnp.bfloat16), jnp.asarray(x), jnp.asarray(sigmas),
        **to_jax(cond)))
    got = port_forward(model, x, sigmas, cond, params=cast_inference_params(
        model.params, torch.bfloat16))
    assert np.abs(got - want).max() <= bf16_ulps(want)
    assert np.mean((got - want) ** 2) < 2e-4


def test_encoder_reuse_2_matches_jax(pair):
    """A 4-step VSampler sample with the encoder run every second step,
    against the JAX model's with the same k; the hooks' state round-trips
    exactly."""
    net, cfg, tree, model = pair
    jax_model = JaxDiffusionModel(net_t=JaxUNetV0, dim=3, **cfg)
    jax_model.params = {"net": tree}
    x, sigmas, cond = nd_inputs(cfg, 3, 4, batch=1)
    want = np.asarray(jax_model.sample(jnp.asarray(x), num_steps=4,
                                       encoder_reuse=2, **to_jax(cond)))
    got = model.sample(x, num_steps=4, encoder_reuse=2,
                       **to_torch(cond)).numpy()
    assert np.mean((got - want) ** 2) <= 1e-6
    assert np.abs(got - model.sample(x, num_steps=4,
                                     **to_torch(cond)).numpy()).max() > 0
    with torch.inference_mode():
        xt, st = torch.from_numpy(x), torch.from_numpy(sigmas[:1])
        full, enc = model.net.apply(model.params, xt, st, return_hidden=True,
                                    **to_torch(cond))
        again = model.net.apply(model.params, xt, st, hidden=enc,
                                **to_torch(cond))
    assert enc[0].shape == (1, 2, 4, 4, 32)  # channels-last bottleneck
    assert torch.equal(full, again)


def test_params_round_trip_and_strictness(pair):
    net, cfg, tree, model = pair
    state = params_from_jax(tree)
    assert set(state) == set(model.net.module.state_dict())
    assert state["inner.proj_out.Conv_0.kernel"].shape == (3, 3, 3, 8, 3)
    assert state["inner.down_1.Dense_0.weight"].shape == (16, 8 * 8)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_jax(state),
                           jax.tree_util.tree_map(np.asarray, tree))
    extra = jax.tree_util.tree_map(lambda a: a, tree)
    extra["inner"]["items_down_2"]["ResnetItem3d_0"]["Conv3d_2"] = {
        "Conv_0": {"kernel": np.zeros((3, 3, 3, 2, 2)), "bias": np.zeros(2)}}
    with pytest.raises(ValueError, match="Conv3d_2"):
        params_from_jax(extra)


def test_channel_change_is_ignored_and_spatial_checks(pair):
    """Dim 3 ignores channel_change, as the JAX factory does; every spatial
    axis must divide by the product of the factors."""
    net, cfg, tree, model = pair
    same = UNetV0(dim=3, device="cpu", channel_change="first_item",
                  lane_fold=False, **ND_CFG)
    assert set(same.module.state_dict()) == set(model.net.module.state_dict())
    with pytest.raises(ValueError, match="dim=1"):
        UNetV0(dim=3, device="cpu", use_pallas=True, **ND_CFG)
    x, sigmas, cond = nd_inputs(cfg, 3, 5)
    with pytest.raises(ValueError, match="divisible"):
        port_forward(model, x[:, :, :6], sigmas, cond)
