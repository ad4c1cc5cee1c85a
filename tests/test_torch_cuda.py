"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (forward and
backward of the fused resnet item) against the plain version and its
autograd, and the port's net and train step on the card against the same on
the CPU. They skip where CUDA is absent. This file imports nothing of JAX, so it
also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float32 (TF32 off) 2e-4, sums taken in another order; bfloat16
two ulps of the largest output (2^-6·max|y|), since one flipped rounding of
conv 1's output moves the item's output by up to about one ulp.
Gradients: each of the 13 is compared with the plain version's autograd
relative to its own largest value, float32 1e-4 (measured 3e-6) and bfloat16
2e-2 (measured 0.012 at the flagship's level shapes: the kernels round the gradients passed between stages
once, autograd wherever the forward casts). With one channel per group
(C = 8) the second GroupNorm removes conv 1's bias, whose gradient is then
zero in exact arithmetic and rounding noise in both: it is compared on the
scale of conv 2's bias gradient.
"""
import functools

import numpy as np
import pytest
import torch

from audio_diffusion_torch import DiffusionModel, UNetV0, make_train_step
from audio_diffusion_torch.diffusion.vdiffusion import v_loss
from audio_diffusion_torch.ops.kernels.resnet import (
    fused_resnet_item, resnet_item_reference)

torch.set_num_threads(2)

GROUPS = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def item_inputs(c, length, b, seed, dtype, device):
    rs = np.random.default_rng(seed)

    def f(*shape, scale=1.0, offset=0.0):
        a = (rs.standard_normal(shape) * scale + offset).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    w = 1.0 / np.sqrt(3 * c)
    return [f(b, length, c), f(c, scale=.1, offset=1.), f(c, scale=.1),
            f(3, c, c, scale=w), f(c, scale=.1), f(c, scale=.1, offset=1.),
            f(c, scale=.1), f(3, c, c, scale=w), f(c, scale=.1),
            f(b, c, scale=.2), f(b, c, scale=.2), f(c, scale=.1, offset=1.),
            f(c, scale=.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,length,use_modulation", [
    (8, 4099, True), (64, 1000, False), (96, 77, True), (1024, 130, True)])
def test_kernel_matches_plain(cuda_device, dtype, channels, length,
                              use_modulation):
    args = item_inputs(channels, length, 2, channels, dtype, cuda_device)
    before = fused_resnet_item.launches
    out = fused_resnet_item(*args, groups=GROUPS,
                            use_modulation=use_modulation)
    torch.cuda.synchronize()
    assert fused_resnet_item.launches == before + 1
    ref = resnet_item_reference(*args, groups=GROUPS,
                                use_modulation=use_modulation)
    err = (out.float() - ref.float()).abs().max().item()
    bound = 2e-4 if dtype == torch.float32 else \
        2.0 ** -6 * ref.float().abs().max().item()
    assert err <= bound, (err, bound)


NAMES = ("x", "gn1s", "gn1b", "k1", "c1b", "gn2s", "gn2b", "k2", "c2b",
         "mods", "modb", "mgs", "mgb")


def item_gradients(fn, args, g, use_modulation):
    n = 13 if use_modulation else 9
    leaves = [t.clone().requires_grad_(True) for t in args[:n]]
    out = fn(*leaves, groups=GROUPS, use_modulation=use_modulation)
    return dict(zip(NAMES, torch.autograd.grad(out, leaves, g)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,length,use_modulation", [
    (8, 4099, True), (64, 1000, False), (96, 77, True), (1024, 130, True)])
def test_backward_kernel_matches_plain_autograd(cuda_device, dtype, channels,
                                                length, use_modulation):
    args = item_inputs(channels, length, 2, channels, dtype, cuda_device)
    g = item_inputs(channels, length, 2, channels + 1, dtype, cuda_device)[0]
    before = (fused_resnet_item.launches, fused_resnet_item.backward_launches)
    got = item_gradients(fused_resnet_item, args, g, use_modulation)
    torch.cuda.synchronize()
    assert (fused_resnet_item.launches, fused_resnet_item.backward_launches) \
        == (before[0] + 1, before[1] + 1)
    want = item_gradients(resnet_item_reference, args, g, use_modulation)
    assert set(got) == set(NAMES[:13 if use_modulation else 9])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, grad in got.items():
        assert grad.shape == want[name].shape and grad.dtype == dtype
        scale = want[name].float().abs().max().item()
        if name == "c1b" and channels == GROUPS:
            scale = want["c2b"].float().abs().max().item()
        err = (grad.float() - want[name].float()).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.cuda
def test_backward_kernel_matches_finite_differences(cuda_device):
    """A gradcheck in float32 at a tiny shape: along a random direction v of
    each input (scaled to the input's own spread), sum(grad · v) against the
    central difference of sum(out · g) through the forward kernel, step
    1e-2. Tolerance 2e-3 of the larger of the two plus 2e-3 (the
    difference's own truncation and float32 cancellation; the plain version
    on the CPU stays within a tenth of it)."""
    args = item_inputs(16, 24, 2, 3, torch.float32, cuda_device)
    g = item_inputs(16, 24, 2, 4, torch.float32, cuda_device)[0]
    grads = item_gradients(fused_resnet_item, args, g, True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    eps = 1e-2

    def phi(i, t):
        with torch.no_grad():
            out = fused_resnet_item(*args[:i], t, *args[i + 1:],
                                    groups=GROUPS)
        return (out.double() * g.double()).sum().item()

    for i, name in enumerate(NAMES):
        v = torch.randn(args[i].shape, generator=gen, device="cuda")
        v = v * args[i].std()
        numeric = (phi(i, args[i] + eps * v) - phi(i, args[i] - eps * v)) / (
            2 * eps)
        analytic = (grads[name].double() * v.double()).sum().item()
        bound = 2e-3 * max(abs(numeric), abs(analytic)) + 2e-3
        assert abs(numeric - analytic) <= bound, (name, numeric, analytic)


@pytest.mark.cuda
def test_kernel_gradient_arrives(cuda_device):
    """A call that needs a gradient runs the forward and backward kernels;
    one that needs none (inference mode, or no input that requires one)
    keeps nothing for a backward."""
    args = item_inputs(32, 64, 1, 0, torch.float32, cuda_device)
    args[3].requires_grad_(True)
    before = fused_resnet_item.backward_launches
    out = fused_resnet_item(*args, groups=GROUPS)
    assert out.requires_grad
    out.sum().backward()
    torch.cuda.synchronize()
    assert fused_resnet_item.backward_launches == before + 1
    assert args[3].grad.shape == args[3].shape
    assert torch.isfinite(args[3].grad).all() and args[3].grad.any()
    with torch.inference_mode():
        assert not fused_resnet_item(*args, groups=GROUPS).requires_grad
    assert fused_resnet_item.backward_launches == before + 1


@pytest.mark.cuda
def test_kernel_rejects_bad_input(cuda_device):
    args = item_inputs(32, 64, 1, 0, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fused_resnet_item(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                          *args[1:], groups=GROUPS)
    with pytest.raises(ValueError, match="k1"):
        fused_resnet_item(args[0], args[1], args[2], args[3][:, :16],
                          *args[4:], groups=GROUPS)
    with pytest.raises(ValueError, match="aligned"):
        unaligned = torch.empty(args[0].numel() + 1, device=cuda_device)[1:]
        fused_resnet_item(unaligned.view_as(args[0]), *args[1:],
                          groups=GROUPS)


@pytest.mark.cuda
def test_net_on_card_matches_cpu(cuda_device):
    cfg = dict(in_channels=2, channels=[8, 32, 64], factors=[1, 4, 2],
               items=[1, 2, 1], attentions=[0, 0, 1], attention_heads=4,
               attention_features=8, modulation_features=64)
    cpu = DiffusionModel(net_t=UNetV0, device="cpu", seed=1, **cfg)
    gpu = DiffusionModel(net_t=UNetV0, device=cuda_device, **cfg)
    gpu.net.module.load_state_dict(cpu.net.module.state_dict())
    noise = np.random.default_rng(2).standard_normal((1, 2, 256)).astype(
        np.float32)
    before = fused_resnet_item.launches
    want = cpu.sample(torch.from_numpy(noise), num_steps=4)
    got = gpu.sample(torch.from_numpy(noise), num_steps=4).cpu()
    assert fused_resnet_item.launches - before == 4 * 2 * (1 + 2 + 1)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < 1e-3


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """One Adam step of the small net in float32, kernels on the card against
    the plain version on the CPU, same weights, batch, σ and noise: loss and
    grad_norm rel 1e-4, every gradient within 1e-3 of its largest value plus
    1e-6·grad_norm."""
    cfg = dict(in_channels=2, channels=[8, 32, 64], factors=[1, 4, 2],
               items=[1, 2, 1], attentions=[0, 0, 1], attention_heads=4,
               attention_features=8, modulation_features=64)
    rs = np.random.default_rng(6)
    x, noise = (rs.standard_normal((2, 2, 256)).astype(np.float32)
                for _ in range(2))
    sigmas = np.array([0.3, 0.8], np.float32)
    cpu = DiffusionModel(net_t=UNetV0, device="cpu", seed=1, **cfg)
    with torch.no_grad():
        for p in cpu.params.values():
            if not p.any():
                p.normal_(0.0, 0.05, generator=cpu.generator)
    gpu = DiffusionModel(net_t=UNetV0, device=cuda_device, **cfg)
    gpu.net.module.load_state_dict(cpu.net.module.state_dict())
    results = {}
    for model in (cpu, gpu):
        dev = model.device

        def loss_fn(params, generator, batch, model=model, dev=dev):
            return v_loss(model.net, params, batch,
                          torch.from_numpy(sigmas).to(dev),
                          torch.from_numpy(noise).to(dev))

        grads = torch.autograd.grad(
            loss_fn(model.params, None, torch.from_numpy(x).to(dev)),
            list(model.params.values()))
        init, step = make_train_step(
            loss_fn, functools.partial(torch.optim.Adam, lr=1e-4))
        before = fused_resnet_item.backward_launches
        _, metrics = step(init(model.params, torch.Generator(device=dev)),
                          torch.from_numpy(x).to(dev))
        results[dev.type] = (metrics, [g.cpu() for g in grads],
                             fused_resnet_item.backward_launches - before)
    (m_cpu, g_cpu, n_cpu), (m_gpu, g_gpu, n_gpu) = results["cpu"], results["cuda"]
    assert (n_cpu, n_gpu) == (0, 2 * (1 + 2 + 1))
    assert m_gpu["loss"].item() == pytest.approx(m_cpu["loss"].item(), rel=1e-4)
    norm = m_cpu["grad_norm"].item()
    assert m_gpu["grad_norm"].item() == pytest.approx(norm, rel=1e-4)
    for name, a, b in zip(cpu.params, g_cpu, g_gpu):
        bound = 1e-3 * a.abs().max().item() + 1e-6 * norm
        assert (a - b).abs().max().item() <= bound, name
