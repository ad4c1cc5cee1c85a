"""Gradients of the port's fused resnet item on the CPU (its plain version
under PyTorch's autograd, which is also what the CUDA backward kernels are
held to on the card) against the JAX package's: ``jax.vjp`` of the lax
reference, and ``jax.grad`` through the interpret-mode Pallas kernel's
custom VJP, at fold 1, on the same numpy inputs and output gradient.

Tolerances. float32: atol = rtol = 1e-3, the bar of tests/test_kernels.py
(measured: ≤ 4e-5 of each gradient's largest value). bfloat16: the two
packages round gradients at different points (the port's autograd rounds
wherever the forward casts to bf16, the JAX VJP at its own casts), so each
gradient is compared relative to its largest value; measured ≤ 0.012, bound
0.03. One gradient is pure rounding noise in both packages: with one channel
per group (C = 8, 8 groups) the second GroupNorm removes conv 1's bias, so
its gradient is zero in exact arithmetic; it is compared on the scale of
conv 2's bias gradient instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu.ops.kernels.resnet import (
    fused_resnet_item as jax_fused_resnet_item, group_map,
    resnet_item_reference as jax_resnet_item_reference)
from audio_diffusion_torch.ops.kernels.resnet import (
    fused_resnet_item, resnet_item_reference, wgrad_slabs)

torch.set_num_threads(2)

NAMES = ("x", "gn1s", "gn1b", "k1", "c1b", "gn2s", "gn2b", "k2", "c2b",
         "mods", "modb", "mgs", "mgb")
GROUPS = 8
LENGTH = 64


def make_inputs(c: int, length: int = LENGTH, b: int = 2, seed: int = 0):
    rs = np.random.default_rng(seed)

    def f(*shape, scale=1.0, offset=0.0):
        return (rs.standard_normal(shape) * scale + offset).astype(np.float32)

    w = 1.0 / np.sqrt(3 * c)
    a = dict(x=f(b, length, c), gn1s=f(c, scale=.1, offset=1.),
             gn1b=f(c, scale=.1), k1=f(3, c, c, scale=w), c1b=f(c, scale=.1),
             gn2s=f(c, scale=.1, offset=1.), gn2b=f(c, scale=.1),
             k2=f(3, c, c, scale=w), c2b=f(c, scale=.1),
             mods=f(b, c, scale=.2), modb=f(b, c, scale=.2),
             mgs=f(c, scale=.1, offset=1.), mgb=f(c, scale=.1))
    return a, f(b, length, c)


def jax_item_args(a, dtype):
    """The JAX reference's differentiable arguments: vectors as [1, W]."""
    j = {k: jnp.asarray(v, dtype) for k, v in a.items()}
    vec = ("gn1s", "gn1b", "c1b", "gn2s", "gn2b", "c2b", "mgs", "mgb")
    return [j[k][None] if k in vec else j[k] for k in NAMES]


def jax_reference_grads(a, g, dtype, use_modulation):
    """jax.vjp of the lax reference at fold 1: 13 gradients as f32 numpy,
    the vectors back as [C]."""
    m = jnp.asarray(group_map(1, a["x"].shape[-1], GROUPS))

    def fn(*args):
        return jax_resnet_item_reference(
            *args[:9], m, *args[9:], use_modulation=use_modulation)

    _, vjp = jax.vjp(fn, *jax_item_args(a, dtype))
    grads = vjp(jnp.asarray(g, dtype))
    return {k: np.asarray(v.astype(jnp.float32)).reshape(a[k].shape)
            for k, v in zip(NAMES, grads)}


def torch_grads(a, g, dtype, use_modulation, fn=resnet_item_reference):
    args = [torch.from_numpy(a[k]).to(dtype).requires_grad_(True)
            for k in NAMES]
    out = fn(*args, groups=GROUPS, use_modulation=use_modulation)
    n = 13 if use_modulation else 9
    grads = torch.autograd.grad(out, args[:n], torch.from_numpy(g).to(dtype))
    return {k: v.float().numpy() for k, v in zip(NAMES, grads)}


@pytest.mark.parametrize("use_modulation", [True, False])
@pytest.mark.parametrize("channels", [8, 32, 64])
def test_plain_item_gradients_match_jax_vjp_f32(channels, use_modulation):
    a, g = make_inputs(channels, seed=channels)
    want = jax_reference_grads(a, g, jnp.float32, use_modulation)
    got = torch_grads(a, g, torch.float32, use_modulation)
    assert set(got) == set(NAMES[:13 if use_modulation else 9])
    for name, grad in got.items():
        np.testing.assert_allclose(grad, want[name], atol=1e-3, rtol=1e-3,
                                   err_msg=name)
    if not use_modulation:  # the JAX VJP gives the unused inputs zeros
        assert all(not want[k].any() for k in NAMES[9:])


def test_x_gradient_matches_jax_custom_vjp_f32():
    """jax.grad through the interpret-mode Pallas kernel (its custom VJP)."""
    a, g = make_inputs(32, seed=5)
    m = jnp.asarray(group_map(1, 32, GROUPS))
    j = jax_item_args(a, jnp.float32)

    def loss(x):
        out = jax_fused_resnet_item(x, *j[1:9], m, m.T, *j[9:], 1e-5, True,
                                    True)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(loss)(j[0]))
    got = torch_grads(a, g, torch.float32, True)["x"]
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("channels", [8, 64])
def test_plain_item_gradients_match_jax_vjp_bf16(channels):
    a, g = make_inputs(channels, seed=channels)
    # Round once, so both packages start from the same bf16 values.
    rnd = lambda v: np.array(  # noqa: E731
        jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    a, g = {k: rnd(v) for k, v in a.items()}, rnd(g)
    want = jax_reference_grads(a, g, jnp.bfloat16, True)
    got = torch_grads(a, g, torch.bfloat16, True)
    for name, grad in got.items():
        scale = np.abs(want[name]).max()
        if name == "c1b" and channels == GROUPS:
            scale = np.abs(want["c2b"]).max()  # zero in exact arithmetic
        assert np.abs(grad - want[name]).max() <= 0.03 * scale, name


def test_wrapper_gradient_on_cpu_is_the_plain_versions():
    a, g = make_inputs(32, length=32, seed=1)
    before = (fused_resnet_item.launches, fused_resnet_item.backward_launches)
    got = torch_grads(a, g, torch.float32, True, fn=fused_resnet_item)
    want = torch_grads(a, g, torch.float32, True)
    assert all(np.array_equal(got[k], want[k]) for k in NAMES)
    # No kernel was launched in either direction.
    assert before == (fused_resnet_item.launches,
                      fused_resnet_item.backward_launches)


@pytest.mark.parametrize("batch,length,channels", [
    (1, 2**18, 8), (8, 2**18, 8), (1, 2**12, 128), (8, 2**10, 512),
    (1, 2**7, 1024), (8, 2**8, 1024), (2, 77, 96), (1, 1, 8)])
def test_wgrad_slabs_cover_every_chunk_within_the_partial_budget(
        batch, length, channels):
    """The weight-gradient kernel's split of its B·L inner dimension: every
    32-position chunk lies in exactly one slab, no slab is empty, and the f32
    partials [slabs, 3, C, C] stay within 16 MiB unless one slab alone is
    larger."""
    per_slab, slabs = wgrad_slabs(batch, length, channels)
    chunks = batch * -(-length // 32)
    assert per_slab >= 1 and slabs >= 1
    assert (slabs - 1) * per_slab < chunks <= slabs * per_slab
    assert slabs == 1 or slabs * 12 * channels * channels <= 16 * 2**20
