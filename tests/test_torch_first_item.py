"""``channel_change="first_item"`` in the port: Downsample keeps the source
width and each level's first resnet item changes it through a 1×1 shortcut
(``shortcut_kernel`` [Cin, C], ``shortcut_bias``), against the JAX package
on the 3-level net of tests/test_model_e2e.py (channels [8, 16, 32],
factors [1, 2, 2], items [1, 2, 1], 128 samples), with the same weights
carried across by ``params_from_jax``.

A width-changing item runs the JAX lax path's math on every device (the
fused kernel takes no shortcut); every other item still goes through
``fused_resnet_item``. Bars (float32): forward max-abs < 1e-3 and MSE <
1e-8; a 4-step sample MSE <= 1e-6; the v-loss rel 1e-5 and each gradient
within 1e-4 of its leaf's largest value against ``jax.grad``, plus
1e-6·grad_norm: ``up_0``'s bias feeds the output GroupNorm with one
channel per group (8 channels, 8 groups), so its gradient is zero in exact
arithmetic and rounding noise (1e-9) in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_tpu.diffusion.core import alpha_beta as jax_alpha_beta
from audio_diffusion_tpu.diffusion.vdiffusion import mse_loss as jax_mse_loss
from audio_diffusion_torch import (DiffusionModel, UNetV0, params_from_jax,
                                   params_to_jax)
from audio_diffusion_torch.diffusion.vdiffusion import v_loss
from audio_diffusion_torch.ops.kernels import resnet as resnet_kernel

torch.set_num_threads(2)

LENGTH = 128
FIRST_ITEM = dict(in_channels=2, channels=[8, 16, 32], factors=[1, 2, 2],
                  items=[1, 2, 1], modulation_features=32, lane_fold=False,
                  channel_change="first_item")
SHORTCUT_ITEMS = ("inner.items_down_1.ResnetModItem_0",
                  "inner.items_down_2.ResnetModItem_0")


def random_tree(net, seed):
    shapes = jax.eval_shape(lambda: net.module.init(
        {"params": jax.random.key(0)}, jnp.zeros((2, 2, LENGTH)),
        jnp.zeros((2,))))["params"]
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        a = rs.randn(*s.shape)
        if "freqs" in name:
            a = a * 16.0
        elif "scale" in name:
            a = 1.0 + 0.1 * a
        elif len(s.shape) >= 2:
            a = a / np.sqrt(np.prod(s.shape[:-1]))
        else:
            a = 0.1 * a
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pair():
    jax_model = JaxDiffusionModel(net_t=JaxUNetV0, **FIRST_ITEM)
    tree = random_tree(jax_model.net, seed=0)
    jax_model.params = {"net": tree}
    model = DiffusionModel(net_t=UNetV0, device="cpu", **FIRST_ITEM)
    model.net.module.load_state_dict(params_from_jax(tree), strict=True)
    return jax_model, tree, model


def batch(seed, b=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 2, LENGTH).astype(np.float32)
    noise = rs.randn(b, 2, LENGTH).astype(np.float32)
    return x, noise, rs.uniform(0.1, 0.9, size=(b,)).astype(np.float32)


def test_forward_matches_jax_and_two_shortcuts(pair):
    jax_model, tree, model = pair
    shortcuts = sorted(n for n in model.params if "shortcut" in n)
    assert shortcuts == sorted(f"{item}.shortcut_{leaf}"
                               for item in SHORTCUT_ITEMS
                               for leaf in ("kernel", "bias"))
    assert model.params[f"{SHORTCUT_ITEMS[0]}.shortcut_kernel"].shape == (
        8, 16)
    assert model.params["inner.down_1.kernel"].shape == (2 * 8, 8)
    x, _, sigmas = batch(1)
    want = np.asarray(jax.jit(jax_model.net.apply)(
        tree, jnp.asarray(x), jnp.asarray(sigmas)))
    with torch.inference_mode():
        got = model.net.apply(model.params, torch.from_numpy(x),
                              torch.from_numpy(sigmas)).numpy()
    assert np.abs(got - want).max() < 1e-3
    assert np.mean((got - want) ** 2) < 1e-8


def test_sample_matches_jax(pair):
    jax_model, tree, model = pair
    x = batch(2, b=1)[0]
    want = np.asarray(jax_model.sample(jnp.asarray(x), num_steps=4))
    got = model.sample(x, num_steps=4).numpy()
    assert np.mean((got - want) ** 2) <= 1e-6


def test_loss_and_gradients_match_jax(pair):
    """The gradients flow through the shortcut: its kernel's gradient is
    not zero, and every leaf matches jax.grad."""
    jax_model, tree, model = pair
    x, noise, sigmas = batch(3)

    def jax_loss(p):
        alphas, betas = jax_alpha_beta(jnp.asarray(sigmas)[:, None, None])
        x_noisy = alphas * x + betas * noise
        return jax_mse_loss(jax_model.net.apply(p, x_noisy,
                                                jnp.asarray(sigmas)),
                            alphas * noise - betas * x)

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(tree)
    params = model.params
    loss = v_loss(model.net, params, torch.from_numpy(x),
                  torch.from_numpy(sigmas), torch.from_numpy(noise))
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    want = params_from_jax(want)
    assert set(want) == set(grads)
    norm = float(torch.linalg.vector_norm(torch.stack(
        [w.norm() for w in want.values()])))
    for name, w in want.items():
        w = w.numpy()
        err = np.abs(grads[name].numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-6 * norm, name
    for item in SHORTCUT_ITEMS:
        assert grads[f"{item}.shortcut_kernel"].abs().max() > 0


def test_width_changing_items_skip_the_kernel(pair, monkeypatch):
    """Routing by geometry: of the 8 items of a pass, the 2 that change
    width never reach the kernel's wrapper; the other 6 do."""
    jax_model, tree, model = pair
    calls = []
    wrapper = resnet_kernel.fused_resnet_item

    def counted(x, *args, **kwargs):
        calls.append(x.shape[-1])
        return wrapper(x, *args, **kwargs)

    monkeypatch.setattr(resnet_kernel, "fused_resnet_item", counted)
    model.sample(batch(4, b=1)[0], num_steps=2)
    assert len(calls) == 2 * 6
    assert sorted(calls[:6]) == [8, 8, 16, 16, 16, 32]


def test_params_round_trip_and_strictness(pair):
    jax_model, tree, model = pair
    state = params_from_jax(tree)
    assert set(state) == set(model.net.module.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_jax(state),
                           jax.tree_util.tree_map(np.asarray, tree))
    broken = jax.tree_util.tree_map(lambda a: a, tree)
    del broken["inner"]["items_down_1"]["ResnetModItem_0"]["shortcut_bias"]
    with pytest.raises(ValueError, match="shortcut_bias"):
        params_from_jax(broken)


def test_init_fan_in_from_each_kernel():
    """lecun-normal with each kernel's own fan-in: conv 1 of a
    width-changing item 3·Cin, its shortcut Cin, conv 2 3·C."""
    model = DiffusionModel(net_t=UNetV0, device="cpu", seed=2,
                           **{**FIRST_ITEM, "channels": [8, 64, 128]})
    p = model.params
    item = "inner.items_down_2.ResnetModItem_0"
    for leaf, fan_in in (("conv1_kernel", 3 * 64), ("shortcut_kernel", 64),
                         ("conv2_kernel", 3 * 128)):
        std = np.sqrt(1.0 / fan_in)
        assert abs(p[f"{item}.{leaf}"].std().item() - std) < 0.05 * std, leaf
    assert not p[f"{item}.shortcut_bias"].any()
    assert p[f"{item}.gn1_scale"].shape == (64,)


def test_construction_errors():
    with pytest.raises(ValueError, match="lane_fold=False"):
        UNetV0(dim=1, device="cpu", **{**FIRST_ITEM, "lane_fold": True})
    with pytest.raises(ValueError, match="channel_change"):
        UNetV0(dim=1, device="cpu", **{**FIRST_ITEM,
                                       "channel_change": "both"})
    with pytest.raises(ValueError, match="items >= 1"):
        UNetV0(dim=1, device="cpu", **{**FIRST_ITEM, "items": [1, 0, 1]})
    # The default geometry declares no shortcut.
    plain = UNetV0(dim=1, device="cpu", **{**FIRST_ITEM,
                                           "channel_change": "resample"})
    assert not any("shortcut" in n for n in plain.module.state_dict())
