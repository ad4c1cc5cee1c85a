"""Weights between the packages: ``params_to_jax`` against
``params_from_jax`` and the JAX ``UNetV0``'s own tree, for every wrapper
combination the port builds (time conditioning, CFG, neither), and a port
model's weights carried back and run by the JAX net. The round trip is pure
numpy and must be bit-equal; the carried-back forward has the f32 bar of
test_parity_full_model.py (max-abs < 1e-3, MSE < 1e-8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_torch import (DiffusionModel, UNetV0, params_from_jax,
                                   params_to_jax)
from test_torch_conditioning import COND, to_torch
from test_torch_unet import CFG, LENGTH, cond_inputs, jax_net_and_params

torch.set_num_threads(2)

VARIANTS = {
    "conditioned": COND,
    "unconditioned": {},
    "skipcat": dict(use_modulation=False, use_time_conditioning=False),
    "cfg_without_time": dict(COND, use_time_conditioning=False,
                             use_modulation=False),
}


def flat(tree):
    return {jax.tree_util.keystr(p): a
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=list(VARIANTS))
def tree(request):
    return jax_net_and_params(seed=41, **VARIANTS[request.param])[2]


def test_round_trip_is_bit_equal(tree):
    state = params_from_jax(tree)
    back = params_to_jax(state)
    want, got = flat(tree), flat(back)
    assert got.keys() == want.keys()
    for k, a in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    # And back again: the state dict is reproduced too.
    again = params_from_jax(back)
    assert again.keys() == state.keys()
    assert all(torch.equal(again[k], v) for k, v in state.items())


def test_leftover_or_missing_leaf_raises(tree):
    state = params_from_jax(tree)
    name = next(k for k in state if k.endswith("conv1_bias"))
    item = name.rsplit(".", 1)[0]
    with pytest.raises(ValueError, match="params_to_jax.*stray"):
        params_to_jax(dict(state, **{item + ".stray": torch.zeros(3)}))
    missing = dict(state)
    del missing[name]
    with pytest.raises(ValueError, match="params_to_jax: missing.*conv1_bias"):
        params_to_jax(missing)

    def resnet_node(t):
        for part in item.split("."):
            t = t[part]
        return t

    back = params_to_jax(state)
    resnet_node(back)["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="params_from_jax.*stray"):
        params_from_jax(back)
    back = params_to_jax(state)
    del resnet_node(back)["conv1_bias"]
    with pytest.raises(ValueError,
                       match="params_from_jax: missing.*conv1_bias"):
        params_from_jax(back)


def test_port_weights_run_in_jax():
    """A port model's own initialization (zero gates given signal),
    carried back: the JAX net reproduces the port's conditioned forward."""
    cfg = {**CFG, **COND}
    model = DiffusionModel(net_t=UNetV0, device="cpu", seed=3, **cfg)
    with torch.no_grad():
        for p in model.params.values():
            if not p.any():
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(4))
    rs = np.random.RandomState(5)
    x = rs.randn(2, 2, LENGTH).astype(np.float32)
    cond = cond_inputs(cfg, rs=rs)
    net = JaxUNetV0(dim=1, **cfg)
    want = np.asarray(jax.jit(net.apply)(
        params_to_jax(model.params), jnp.asarray(x),
        jnp.full((2,), 0.7, jnp.float32), **cond))
    with torch.inference_mode():
        got = model.net.apply(model.params, torch.from_numpy(x),
                              torch.full((2,), 0.7), **to_torch(cond)).numpy()
    assert np.abs(got - want).max() < 1e-3
    assert np.mean((got - want) ** 2) < 1e-8
