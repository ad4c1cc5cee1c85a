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
import sys

import numpy as np
import pytest
import torch

from audio_diffusion_torch import DiffusionModel, UNetV0, make_train_step
from audio_diffusion_torch.diffusion.vdiffusion import v_loss
from audio_diffusion_torch.ops.kernels.resnet import (
    conv_plan, fused_resnet_item, resnet_item_reference, wgrad_plan)

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


@pytest.mark.cuda
@pytest.mark.parametrize("channels,length,batch,split_k,bn", [
    (1024, 128, 1, True, 128), (512, 1024, 1, True, 128),
    (8, 2**14 + 3, 1, False, 8)])
def test_bf16_conv_plans_match_plain(cuda_device, channels, length, batch,
                                     split_k, bn):
    """The bf16 item through the split-K path of its conv (levels 8 and 5 at
    batch 1) and through the N = 8 tile with a ragged last row tile, against
    the plain version at two ulps; a second call gives the same bits."""
    plan = conv_plan(batch, length, channels,
                     torch.cuda.get_device_properties(0).multi_processor_count)
    assert (plan["splits"] > 1) == split_k and plan["bn"] == bn
    args = item_inputs(channels, length, batch, channels, torch.bfloat16,
                       cuda_device)
    before = fused_resnet_item.launches
    out = fused_resnet_item(*args, groups=GROUPS)
    again = fused_resnet_item(*args, groups=GROUPS)
    torch.cuda.synchronize()
    assert fused_resnet_item.launches == before + 2
    assert torch.equal(out, again)
    ref = resnet_item_reference(*args, groups=GROUPS)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -6 * ref.float().abs().max().item(), err


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
@pytest.mark.parametrize("channels,length,batch,dgrad_split,wgrad_tile", [
    (1024, 128, 1, True, 128), (8, 2**14 + 3, 1, False, 8),
    (32, 2**14 + 3, 1, False, 32), (64, 1000, 2, True, 64),
    (128, 1000, 8, True, 128), (256, 2048, 8, False, 128)])
def test_bf16_backward_plans_match_plain_autograd(
        cuda_device, channels, length, batch, dgrad_split, wgrad_tile):
    """The bf16 backward through each of its convolutions' paths: the data
    gradient with split-K (level 8's shape, and ragged ones) and without
    (level 4's shape at batch 8), the weight gradient's narrow tiles at
    C = 8 and 32 with a ragged last chunk, its wgmma tiles over many slabs
    and in one, at batch 1, 2 and 8; all 13 gradients against the plain
    version's autograd at 2e-2 of each one's largest value, and a second
    backward gives the same bits."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert (conv_plan(batch, length, channels, sms)["splits"] > 1) \
        == dgrad_split
    assert wgrad_plan(batch, length, channels, sms)["tile"] == wgrad_tile
    args = item_inputs(channels, length, batch, channels, torch.bfloat16,
                       cuda_device)
    g = item_inputs(channels, length, batch, channels + 1, torch.bfloat16,
                    cuda_device)[0]
    got = item_gradients(fused_resnet_item, args, g, True)
    again = item_gradients(fused_resnet_item, args, g, True)
    torch.cuda.synchronize()
    assert all(torch.equal(got[k], again[k]) for k in NAMES)
    want = item_gradients(resnet_item_reference, args, g, True)
    for name, grad in got.items():
        scale = want[name].float().abs().max().item()
        if name == "c1b" and channels == GROUPS:
            scale = want["c2b"].float().abs().max().item()
        err = (grad.float() - want[name].float()).abs().max().item()
        assert err <= 2e-2 * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("channels,length,batch", [
    (1024, 64, 1), (1024, 32, 1), (1024, 32, 8), (8, 2**16, 1)])
def test_bf16_no_modulation_short_levels(cuda_device, channels, length,
                                         batch):
    """The no-modulation branch (the autoregressive model's items) at its
    shortest levels, fewer rows than one conv tile and than one weight-
    gradient chunk, and at its widest: the forward at two ulps and the 9
    gradients at 2e-2 of the plain version's, each bit-identical on a
    second call."""
    args = item_inputs(channels, length, batch, channels, torch.bfloat16,
                       cuda_device)
    g = item_inputs(channels, length, batch, channels + 1, torch.bfloat16,
                    cuda_device)[0]
    kw = dict(groups=GROUPS, use_modulation=False)
    out, again = (fused_resnet_item(*args[:9], **kw) for _ in range(2))
    ref = resnet_item_reference(*args[:9], **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -6 * ref.float().abs().max().item(), err
    got = item_gradients(fused_resnet_item, args, g, False)
    second = item_gradients(fused_resnet_item, args, g, False)
    want = item_gradients(resnet_item_reference, args, g, False)
    assert set(got) == set(NAMES[:9])
    for name, grad in got.items():
        assert torch.equal(grad, second[name]), name
        scale = want[name].float().abs().max().item()
        if name == "c1b" and channels == GROUPS:
            scale = want["c2b"].float().abs().max().item()
        err = (grad.float() - want[name].float()).abs().max().item()
        assert err <= 2e-2 * scale, (name, err, scale)


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


@pytest.mark.cuda
def test_conditioned_net_on_card_matches_cpu(cuda_device):
    """The small net with cross-attention, context injection and CFG: a
    guided 4-step sample, plain and with encoder reuse, on the card against
    the same weights on the CPU (float32, max-abs 1e-3); the guided pass
    launches the item at batch 2 once per step, and a reuse step's decoder
    half of them."""
    cfg = dict(in_channels=2, channels=[8, 32, 64], factors=[1, 4, 2],
               items=[1, 2, 1], attentions=[0, 0, 1], attention_heads=4,
               attention_features=8, modulation_features=64,
               cross_attentions=[0, 0, 1], context_channels=[0, 0, 5],
               use_embedding_cfg=True, embedding_max_length=8,
               embedding_features=32)
    cpu = DiffusionModel(net_t=UNetV0, device="cpu", seed=1, **cfg)
    with torch.no_grad():
        for p in cpu.params.values():
            if not p.any():
                p.normal_(0.0, 0.05, generator=cpu.generator)
    gpu = DiffusionModel(net_t=UNetV0, device=cuda_device, **cfg)
    gpu.net.module.load_state_dict(cpu.net.module.state_dict())
    rs = np.random.default_rng(3)
    noise = torch.from_numpy(rs.standard_normal((1, 2, 256)).astype(np.float32))
    emb = torch.from_numpy(rs.standard_normal((1, 8, 32)).astype(np.float32))
    ctx = torch.from_numpy(rs.standard_normal((1, 5, 32)).astype(np.float32))
    per_pass = 2 * (1 + 2 + 1)
    for reuse, launches in ((1, 4 * per_pass), (2, 2 * per_pass + 2 * 4)):
        kw = dict(num_steps=4, embedding_scale=3.0, encoder_reuse=reuse)
        want = cpu.sample(noise, embedding=emb, channels=[None, None, ctx],
                          **kw)
        before = fused_resnet_item.launches
        got = gpu.sample(noise, embedding=emb.cuda(),
                         channels=[None, None, ctx.cuda()], **kw).cpu()
        assert fused_resnet_item.launches - before == launches
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() < 1e-3, reuse


@pytest.mark.cuda
@pytest.mark.parametrize("channels,length,batch,use_modulation", [
    (512, 1024, 1, False), (512, 1024, 8, False), (8, 2**16, 16, True),
    (256, 2048, 16, True), (1024, 128, 16, True)])
def test_bf16_task_model_shapes(cuda_device, channels, length, batch,
                                use_modulation):
    """The task models' new item shapes: the autoencoder encoder's
    no-modulation item (C = 512, L = 1,024) at batch 1 and 8, and the
    modulated item at the vocoder train step's batch of 16 (levels 0, 4
    and 8). The forward at two ulps and every gradient at 2e-2 of the
    plain version's, each bit-identical on a second call."""
    args = item_inputs(channels, length, batch, channels, torch.bfloat16,
                       cuda_device)
    g = item_inputs(channels, length, batch, channels + 1, torch.bfloat16,
                    cuda_device)[0]
    n = 13 if use_modulation else 9
    kw = dict(groups=GROUPS, use_modulation=use_modulation)
    out, again = (fused_resnet_item(*args[:n], **kw) for _ in range(2))
    ref = resnet_item_reference(*args[:n], **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -6 * ref.float().abs().max().item(), err
    got = item_gradients(fused_resnet_item, args, g, use_modulation)
    second = item_gradients(fused_resnet_item, args, g, use_modulation)
    want = item_gradients(resnet_item_reference, args, g, use_modulation)
    for name, grad in got.items():
        assert torch.equal(grad, second[name]), name
        scale = want[name].float().abs().max().item()
        if name == "c1b" and channels == GROUPS:
            scale = want["c2b"].float().abs().max().item()
        err = (grad.float() - want[name].float()).abs().max().item()
        assert err <= 2e-2 * scale, (name, err, scale)


@pytest.mark.cuda
def test_task_models_on_card_match_cpu(cuda_device):
    """A small upsampler, vocoder and autoencoder (the configs of
    tests/test_task_models.py): 3-step samples on the card against the
    same weights on the CPU from the same noise (float32, max-abs 1e-3),
    the autoencoder's latent too; every extra module lives on the card."""
    from unittest import mock

    from audio_diffusion_torch import (DiffusionAE, DiffusionUpsampler,
                                       DiffusionVocoder, MelEncoder1d)
    from audio_diffusion_torch.diffusion import noise as noise_module

    net = dict(channels=[8, 32, 64], factors=[1, 4, 2], items=[1, 1, 1],
               modulation_features=64)
    enc = dict(in_channels=2, channels=32, out_channels=4, factors=[2],
               num_blocks=[1], mel_channels=16, mel_n_fft=64,
               mel_sample_rate=16000)
    builders = [
        lambda dev: DiffusionUpsampler(net_t=UNetV0, in_channels=2,
                                       upsample_factor=4, device=dev, **net),
        lambda dev: DiffusionVocoder(net_t=UNetV0, mel_channels=16,
                                     mel_n_fft=128, mel_sample_rate=16000,
                                     mel_normalize_log=True, device=dev,
                                     **net),
        lambda dev: DiffusionAE(net_t=UNetV0, in_channels=2, inject_depth=2,
                                encoder=MelEncoder1d(device=dev, **enc),
                                channels=[8, 16, 32], factors=[1, 4, 8],
                                items=[1, 1, 1], modulation_features=32,
                                device=dev)]
    rs = np.random.default_rng(5)
    audio = torch.from_numpy(rs.standard_normal((1, 2, 1024)).astype(
        np.float32))
    start = torch.from_numpy(rs.standard_normal((2, 2, 1024)).astype(
        np.float32))

    def normal(generator, shape, dtype, device):
        return start.reshape(-1)[:int(np.prod(shape))].reshape(
            tuple(shape)).to(dtype=dtype, device=device)

    for build in builders:
        cpu, gpu = build("cpu"), build(cuda_device)
        gpu.net.module.load_state_dict(cpu.net.module.state_dict())
        for prefix, module in gpu.extras.items():
            module.load_state_dict(cpu.extras[prefix].state_dict())
            assert all(p.is_cuda for p in module.parameters())
        outs = []
        for model in (cpu, gpu):
            x = audio.to(model.device)
            with mock.patch.object(noise_module, "normal", normal):
                if isinstance(model, DiffusionUpsampler):
                    outs.append(model.sample(x[..., ::4], num_steps=3))
                elif isinstance(model, DiffusionVocoder):
                    outs.append(model.sample(model.to_spectrogram(x),
                                             num_steps=3))
                else:
                    latent = model.encode(x)
                    outs.append(torch.cat([latent.flatten(), model.decode(
                        latent, num_steps=3).flatten()]))
        want, got = outs[0], outs[1].cpu()
        assert torch.isfinite(got).all() and got.shape == want.shape
        assert (got - want).abs().max().item() < 1e-3


def _pcm16_corpus(path, n_files=3, frames=400):
    """PCM16 files whose samples encode (file, position)."""
    import wave

    path.mkdir()
    for i in range(n_files):
        data = np.stack([i * 1000 + np.arange(frames)] * 2)
        data[1] += 7
        with wave.open(str(path / f"f{i}.wav"), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(np.ascontiguousarray(data.T.astype("<i2"))
                          .tobytes())
    return path


@pytest.mark.cuda
def test_device_corpus_on_card(cuda_device, tmp_path):
    """The corpus lives on the card as int16 and every crop is a window of
    a file, pure in the step."""
    from audio_diffusion_torch.data import DeviceCorpus

    d = _pcm16_corpus(tmp_path / "corpus")
    dc = DeviceCorpus(d, crop_frames=64, batch_size=32, seed=3)
    assert dc._corpus.is_cuda and dc._corpus.dtype == torch.int16
    batch = dc.batch_at(4)
    assert batch.is_cuda and batch.shape == (32, 2, 64)
    assert torch.equal(batch, dc.batch_at(4))
    rows = batch.cpu().numpy()
    starts = rows[:, 0, :1]
    assert (rows[:, 0] == starts + np.arange(64)).all()
    assert (rows[:, 1] == rows[:, 0] + 7).all()
    assert ((starts % 1000) <= 400 - 64).all()


TRAIN_NET = dict(in_channels=2, channels=[8, 32, 64], factors=[1, 4, 2],
                 items=[1, 2, 1], attentions=[0, 0, 1], attention_heads=4,
                 attention_features=8, modulation_features=64,
                 dtype=torch.bfloat16)


@pytest.mark.cuda
def test_trainer_resume_bit_exact_on_card(cuda_device, tmp_path):
    """3 straight Trainer steps (warmup, cosine, clipping, EMA) against 2,
    a checkpoint, a fresh model and trainer restored from it, and 1 more:
    the same bits in the parameters, the EMA and the moments."""
    from audio_diffusion_torch.data import DeviceCorpus, wav_write
    from audio_diffusion_torch.train import Trainer, TrainerConfig

    rs = np.random.default_rng(0)
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i in range(2):
        wav_write(wavs / f"f{i}.wav", rs.uniform(-.5, .5, (2, 2048)), 16000)
    dc = DeviceCorpus(wavs, crop_frames=1024, batch_size=4)
    cfg = dict(learning_rate=1e-3, lr_schedule="cosine", warmup_steps=1,
               total_steps=5, max_grad_norm=0.5, ema_decay=0.9,
               log_every=100, checkpoint_every=2, max_checkpoints=1)

    def trainer(**extra):
        return Trainer(DiffusionModel(net_t=UNetV0, **TRAIN_NET),
                       TrainerConfig(**cfg, **extra), log_fn=lambda s: None)

    straight = trainer()
    straight.fit((dc.batch_at(i) for i in range(3)), num_steps=3)
    first = trainer(checkpoint_dir=str(tmp_path / "ck"))
    first.fit((dc.batch_at(i) for i in range(2)), num_steps=2)
    del first
    resumed = trainer(checkpoint_dir=str(tmp_path / "ck"))
    assert resumed.restore_latest() == 2
    resumed.fit(iter([dc.batch_at(2)]), num_steps=1)
    a, b = straight.state, resumed.state
    for name, p in a.params.items():
        assert torch.equal(p, b.params[name]), name
        assert torch.equal(a.ema[name], b.ema[name]), name
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[p][k],
                               b.optimizer.state[b.params[name]][k]), name


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "dots_with_no_batch_dims_saveable"])
def test_remat_bit_equal_on_card(cuda_device, policy):
    """With use_remat the loss and every gradient are the bits of the net
    without it; the forward kernel runs again in the backward (its launch
    is outside the dispatcher, so no policy saves it): 2 x 8 forward and 8
    backward item launches for the 8 items of a pass."""
    from audio_diffusion_torch.ops.kernels import resnet

    gen = torch.Generator(device=cuda_device)
    x = torch.randn(2, 2, 1024, device=cuda_device,
                    generator=gen.manual_seed(1))
    results = []
    for remat in (False, True):
        model = DiffusionModel(net_t=UNetV0, use_remat=remat,
                               remat_policy=policy if remat else None,
                               seed=4, **TRAIN_NET)
        leaves = list(model.params.values())
        item = resnet.fused_resnet_item
        item.launches = item.backward_launches = 0
        loss = model.loss(model.params, gen.manual_seed(2), x)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        results.append((loss, grads, item.launches, item.backward_launches))
    (l0, g0, f0, b0), (l1, g1, f1, b1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert (f0, b0) == (8, 8) and (f1, b1) == (16, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("use_modulation", [True, False])
def test_operator_matches_direct_launch(cuda_device, use_modulation):
    """The registered operator (a trace's route), the wrapper without a
    gradient (eager code's route) and the launcher called directly run the
    same kernel: the same bits, one launch counted each."""
    from audio_diffusion_torch.ops.kernels import resnet

    args = item_inputs(64, 2048, 2, 5, torch.bfloat16, cuda_device)
    args = args if use_modulation else args[:9] + [None] * 4
    with torch.inference_mode():
        before = fused_resnet_item.launches
        op = torch.ops.audio_diffusion_torch.fused_resnet_item(
            *args, GROUPS, 1e-5, use_modulation)
        assert fused_resnet_item.launches == before + 1
        routed = fused_resnet_item(*args, groups=GROUPS,
                                   use_modulation=use_modulation)
        direct = resnet._launch_forward(args[0], args[1:], GROUPS, 1e-5,
                                        use_modulation, keep=False)[0]
    assert fused_resnet_item.launches == before + 3
    assert torch.equal(op, direct) and torch.equal(routed, direct)


@pytest.mark.cuda
def test_pcm16_and_dequantization_on_card(cuda_device):
    """to_pcm16 and int8/int4 dequantization (f32 and bf16) give the CPU's
    bits on the card."""
    from audio_diffusion_torch import dequantize_params, quantize_params
    from audio_diffusion_torch.serve import to_pcm16

    rs = np.random.default_rng(0)
    x = torch.from_numpy(rs.uniform(-1.3, 1.3, (2, 4096)).astype(np.float32))
    x[0, :3] = torch.tensor([0.5 / 32767, -0.5 / 32767, 2.5 / 32767])
    assert torch.equal(to_pcm16(x.to(cuda_device)).cpu(), to_pcm16(x))
    params = {"a.weight": torch.from_numpy(
                  rs.standard_normal((96, 257)).astype(np.float32)),
              "conv1_kernel": torch.from_numpy(
                  rs.standard_normal((3, 64, 64)).astype(np.float32))}
    for bits in (8, 4):
        cpu = quantize_params(params, min_size=16, bits=bits)
        card = quantize_params({k: v.to(cuda_device)
                                for k, v in params.items()},
                               min_size=16, bits=bits)
        for name in params:
            assert torch.equal(card[name].q.cpu(), cpu[name].q), name
            assert torch.equal(card[name].qscale.cpu(), cpu[name].qscale)
        for dtype in (None, torch.bfloat16):
            want = dequantize_params(cpu, dtype)
            got = dequantize_params(card, dtype)
            for name in params:
                assert torch.equal(got[name].cpu(), want[name]), name


@pytest.mark.cuda
def test_export_on_card_records_the_operator(cuda_device, tmp_path):
    """On the card the exported step holds one operator node per item and
    the artifact gives model.sample's bits."""
    from audio_diffusion_torch import export_sampler, load_sampler

    model = DiffusionModel(net_t=UNetV0, in_channels=2, channels=[8, 32],
                           factors=[1, 2], items=[1, 1],
                           modulation_features=32, dtype=torch.bfloat16)
    export_sampler(model, tmp_path, length=256, num_steps=3)
    program = torch.export.load(tmp_path / "step.pt2")
    ops = [n for n in program.graph.nodes if n.op == "call_function"
           and "fused_resnet_item" in str(n.target)]
    assert len(ops) == 4  # two items, down and up
    sampler, manifest = load_sampler(tmp_path)
    assert manifest["platforms"] == ["cuda"]
    noise = torch.randn(1, 2, 256, device=cuda_device)
    assert torch.equal(sampler(model.params, noise),
                       model.sample(noise, num_steps=3))


# The attention item's fast routes (ops/kernels/attention.py) against their
# plain versions on the card, in bfloat16. The library's LayerNorm sums its
# f32 moments by Welford's method and scales after normalising, so an output
# may round to the neighbouring bf16 value: one ulp of the largest output,
# 2^-7·max|y| (float32 output: 1e-5·max|y|). The attention core sums the logits and the
# output in another order, so where an f32 sum lands on the other side of a
# bf16 rounding boundary a probability or an output element rounds to its
# neighbour (each is rounded once, after the normalisation, in both). On
# these inputs such flips give a relative L2 error of about 1e-4 (the plain
# core with float64 sums reads 4e-5 to 9e-5 against the f32 one), while
# logits rounded to bf16 read 4.4e-3 to 4.9e-3 and one key tile left out
# 0.26 and more: the bar is 2^-10 (about 1e-3). The largest error is held
# to four ulps of the largest output, 2^-5·max|y| (float64 sums read at
# most 2.6e-3·max|y|), which a fault confined to a few rows exceeds.
# Reruns give the same bits.
ATTN_SHAPES = ([("self", s, s) for s in (1024, 512, 256, 128)]
               + [("cross", s, 64) for s in (4096, 2048, 1024, 512, 256, 128)])


def attention_inputs(kind, s, n, b, heads, d, seed, device):
    rs = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rs.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=torch.bfloat16)

    if kind == "self":
        return f(b, s, 3 * heads * d).chunk(3, dim=-1)
    return f(b, s, heads * d), f(b, n, heads * d), f(b, n, heads * d)


def check_attention_core(q, k, v, heads):
    from audio_diffusion_torch.ops.kernels.attention import (
        attention_core, attention_core_reference)

    with torch.inference_mode():
        before = attention_core.launches
        got = attention_core(q, k, v, heads)
        again = attention_core(q, k, v, heads)
        want = attention_core_reference(q, k, v, heads)
    assert attention_core.launches - before == 2
    assert torch.equal(got, again)
    diff, want = got.float() - want.float(), want.float()
    rel = (diff.norm() / want.norm()).item()
    err = diff.abs().max().item()
    assert rel <= 2.0 ** -10, rel
    assert err <= 2.0 ** -5 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("kind,s,n", ATTN_SHAPES)
def test_attention_core_kernel_matches_plain(cuda_device, kind, s, n):
    """The README nets' shapes: self-attention at levels 5-8, cross-attention
    at levels 3-8 over 64 keys, 8 heads of 64, at item batch 1, 2 (CFG) and
    8 (the service); q, k and v as the projections give them."""
    for b in (1, 2, 8):
        check_attention_core(*attention_inputs(kind, s, n, b, 8, 64, b,
                                               cuda_device), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,s,n,heads,d", [
    ("self", 200, 200, 3, 48), ("cross", 65, 130, 2, 128),
    ("cross", 64, 1, 1, 16), ("self", 100, 100, 4, 112)])
def test_attention_core_kernel_other_shapes(cuda_device, kind, s, n, heads, d):
    """Lengths off the 64-row and 64-key tiles, and head widths that take
    several wgmma widths."""
    check_attention_core(*attention_inputs(kind, s, n, 2, heads, d, 7,
                                           cuda_device), heads)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [128, 256, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_matches_plain(cuda_device, channels, dtype):
    """The README nets' attention widths, over a level's rows at batch 2."""
    from audio_diffusion_torch.ops.kernels.attention import (
        layer_norm, layer_norm_reference)

    rs = np.random.default_rng(channels)

    def f(*shape, dtype, scale=1.0, offset=0.0):
        a = rs.standard_normal(shape).astype(np.float32) * scale + offset
        return torch.from_numpy(a).to(device=cuda_device, dtype=dtype)

    rows = 2 * 2 ** 20 // channels // 64 * 64  # the level's B·S at batch 2
    x = f(rows, channels, dtype=dtype, scale=3.0, offset=0.5)
    scale = f(channels, dtype=dtype, scale=0.2, offset=1.0)
    bias = f(channels, dtype=dtype, scale=0.2)
    with torch.inference_mode():
        before = layer_norm.launches
        got = layer_norm(x, scale, bias, 1e-6, dtype)
        again = layer_norm(x, scale, bias, 1e-6, dtype)
        want = layer_norm_reference(x, scale, bias, 1e-6, dtype)
    assert layer_norm.launches - before == 2
    assert got.dtype == dtype and torch.equal(got, again)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


ATTN_NET = dict(in_channels=2, channels=[8, 32, 64], factors=[1, 4, 2],
                items=[1, 2, 1], attentions=[0, 0, 1],
                cross_attentions=[0, 0, 1], attention_heads=2,
                attention_features=64, modulation_features=64,
                embedding_features=32, use_embedding_cfg=True,
                embedding_max_length=8, dtype=torch.bfloat16)


@pytest.mark.cuda
def test_attention_launch_gate(cuda_device):
    """A guided bf16 sample launches one attention core and two LayerNorms
    per attention item and pass (a self- and a cross-attention item on each
    side of the deepest level), and the item kernel as before; a training
    loss under autograd launches none of the attention kernels."""
    from audio_diffusion_torch.ops.kernels.attention import (attention_core,
                                                             layer_norm)

    model = DiffusionModel(net_t=UNetV0, **ATTN_NET)
    noise = torch.randn(1, 2, 256, device=cuda_device)
    emb = torch.randn(1, 8, 32, device=cuda_device)
    def counters():
        return (attention_core.launches, layer_norm.launches,
                fused_resnet_item.launches)

    before = counters()
    out = model.sample(noise, embedding=emb, embedding_scale=3.0, num_steps=3)
    assert torch.isfinite(out).all()
    items = 2 * 2  # self and cross, down and up
    assert tuple(a - b for a, b in zip(counters(), before)) == (
        3 * items, 3 * 2 * items, 3 * 2 * (1 + 2 + 1))
    before = counters()
    loss = model(torch.randn(2, 2, 256, device=cuda_device),
                 embedding=torch.randn(2, 8, 32, device=cuda_device))
    loss.backward()
    assert counters()[:2] == before[:2]


@pytest.mark.cuda
def test_export_on_card_records_the_attention_operators(cuda_device,
                                                        tmp_path):
    """On the card an exported step with attention items holds one
    attention-core node and two (ATen) LayerNorm nodes per item, beside the
    item operator, and the artifact gives model.sample's bits."""
    from audio_diffusion_torch import export_sampler, load_sampler

    model = DiffusionModel(net_t=UNetV0, in_channels=2, channels=[8, 32],
                           factors=[1, 2], items=[1, 1], attentions=[0, 1],
                           attention_heads=2, attention_features=64,
                           modulation_features=32, dtype=torch.bfloat16)
    export_sampler(model, tmp_path, length=256, num_steps=3)
    program = torch.export.load(tmp_path / "step.pt2")
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    count = lambda name: sum(name in t for t in targets)  # noqa: E731
    assert (count("attention_core"), count("layer_norm"),
            count("fused_resnet_item")) == (2, 4, 4)
    sampler, _ = load_sampler(tmp_path)
    noise = torch.randn(1, 2, 256, device=cuda_device)
    assert torch.equal(sampler(model.params, noise),
                       model.sample(noise, num_steps=3))


@pytest.mark.cuda
@pytest.mark.parametrize("guided", [False, True])
def test_distill_stage_step_launch_counts(cuda_device, guided):
    """One step of a halving stage runs two no-grad teacher passes and the
    student's forward and backward: 3 + 1 item passes each way (a guided
    step: one teacher pass at twice the batch, then the student's). Every
    parameter moves but the fixed embedding, which only the teacher's
    guided pass reads."""
    from audio_diffusion_torch import ProgressiveDistiller

    cond = (dict(cross_attentions=[0, 1], attention_heads=2,
                 attention_features=8, embedding_features=16,
                 use_embedding_cfg=True, embedding_max_length=4)
            if guided else {})
    model = DiffusionModel(net_t=UNetV0, in_channels=2, channels=[8, 32],
                           factors=[1, 2], items=[1, 1],
                           modulation_features=32, **cond)
    with torch.no_grad():  # the zero-initialized gates carry signal too
        for p in model.params.values():
            if not p.any():
                p.normal_(0.0, 0.05, generator=model.generator)
    before = {k: v.detach().clone() for k, v in model.params.items()}
    x = torch.randn(2, 2, 256, device=cuda_device)
    distiller = ProgressiveDistiller(model, base_steps=4)
    fwd, bwd = fused_resnet_item.launches, fused_resnet_item.backward_launches
    if guided:
        emb = torch.randn(2, 4, 16, device=cuda_device)
        m = distiller.guidance_stage(iter([(x, {"embedding": emb})]), 3.0, 1,
                                     log_fn=lambda s: None)
    else:
        m = distiller.stage(iter([x]), 1, log_fn=lambda s: None)
    per_pass = 2 * (1 + 1)
    assert (fused_resnet_item.launches - fwd,
            fused_resnet_item.backward_launches - bwd) == (
        (2 if guided else 3) * per_pass, per_pass)
    assert torch.isfinite(m["loss"])
    still = [k for k, v in model.params.items() if torch.equal(v, before[k])]
    assert still == (["inner.fixed_embedding"] if guided else [])


@pytest.mark.cuda
def test_embedder_on_card_matches_cpu(cuda_device):
    """The CorpusEmbedder's embed with the same parameters on the card and
    on the CPU (float32, TF32 off): max-abs ≤ 1e-4 and unit norm."""
    from audio_diffusion_torch import CorpusEmbedder

    kw = dict(features=8, sample_rate=8000, crop=1088, n_mels=24, n_fft=256,
              hop=64, widths=(24, 32))
    corpus = np.random.default_rng(1).standard_normal((4, 2, 4096)).astype(
        np.float32) * 0.3
    cpu = CorpusEmbedder(device="cpu", **kw)
    gpu = CorpusEmbedder(device=cuda_device, **kw)
    params = cpu.train(corpus, steps=3, batch=4)
    trained = gpu.train(corpus, steps=3, batch=4)
    assert all(v.is_cuda for v in trained.values())
    want = cpu.embed(params, corpus)
    got = gpu.embed({k: v.to(cuda_device) for k, v in params.items()},
                    corpus)
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.cuda
def test_export_encoder_reuse_on_card(cuda_device, tmp_path):
    """encoder_reuse=2 on the card: the artifact gives model.sample's bits
    with the same launches (a full pass of 4 items, then a decoder pass
    of 2, per chunk)."""
    from audio_diffusion_torch import export_sampler, load_sampler

    model = DiffusionModel(net_t=UNetV0, in_channels=2, channels=[8, 32],
                           factors=[1, 2], items=[1, 1],
                           modulation_features=32, dtype=torch.bfloat16)
    export_sampler(model, tmp_path, length=256, num_steps=4,
                   encoder_reuse=2)
    sampler, manifest = load_sampler(tmp_path)
    assert manifest["encoder_reuse"] == 2
    noise = torch.randn(1, 2, 256, device=cuda_device)
    want = model.sample(noise, num_steps=4, encoder_reuse=2)
    before = fused_resnet_item.launches
    assert torch.equal(sampler(model.params, noise), want)
    assert fused_resnet_item.launches - before == 2 * (4 + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_nd_net_on_card_matches_cpu(cuda_device, dim):
    """A small 2-D/3-D net (cross-attention, context injection, CFG) on
    the card (cuDNN convs, float32, TF32 off) against the CPU: a guided
    4-step sample with encoder reuse, max-abs < 1e-3, and a rerun on the
    card bit for bit."""
    cfg = dict(in_channels=3, channels=[8, 16, 32], factors=[1, 2, 2],
               items=[1, 2, 1], attentions=[0, 0, 1],
               cross_attentions=[0, 0, 1], context_channels=[0, 8, 0],
               attention_heads=2, attention_features=8, resnet_groups=4,
               modulation_features=16, embedding_features=12,
               use_embedding_cfg=True, embedding_max_length=5)
    spatial = (16, 16) if dim == 2 else (8, 16, 16)
    cpu = DiffusionModel(net_t=UNetV0, dim=dim, device="cpu", seed=1, **cfg)
    gpu = DiffusionModel(net_t=UNetV0, dim=dim, device=cuda_device, **cfg)
    gpu.net.module.load_state_dict(cpu.net.module.state_dict())
    rs = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rs.standard_normal(s).astype(np.float32))
    noise, emb = f(1, 3, *spatial), f(1, 5, 12)
    ctx = f(1, 8, *(s // 2 for s in spatial))
    kw = dict(num_steps=4, embedding_scale=3.0, encoder_reuse=2)
    want = cpu.sample(noise, embedding=emb, channels=[None, ctx], **kw)
    runs = [gpu.sample(noise, embedding=emb.to(cuda_device),
                       channels=[None, ctx.to(cuda_device)], **kw).cpu()
            for _ in range(2)]
    assert torch.isfinite(runs[0]).all()
    assert (runs[0] - want).abs().max().item() < 1e-3
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_first_item_net_on_card_matches_cpu(cuda_device):
    """channel_change="first_item" on the card: the two width-changing
    items run the plain math, the other six launch the kernel (6 per
    pass), and a 4-step sample matches the CPU's (float32)."""
    cfg = dict(in_channels=2, channels=[8, 16, 32], factors=[1, 2, 2],
               items=[1, 2, 1], modulation_features=32, lane_fold=False,
               channel_change="first_item")
    cpu = DiffusionModel(net_t=UNetV0, device="cpu", seed=1, **cfg)
    gpu = DiffusionModel(net_t=UNetV0, device=cuda_device, **cfg)
    gpu.net.module.load_state_dict(cpu.net.module.state_dict())
    noise = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 2, 128)).astype(np.float32))
    want = cpu.sample(noise, num_steps=4)
    before = fused_resnet_item.launches
    got = gpu.sample(noise, num_steps=4).cpu()
    assert fused_resnet_item.launches - before == 4 * 6
    assert (got - want).abs().max().item() < 1e-3


@pytest.mark.cuda
def test_group_norm_statistics_kernel_matches_plain(cuda_device):
    """Without a gradient the plain GroupNorm takes its statistics from the
    item's statistics kernels (tile sums in double); with one, from torch's
    reductions: the two agree to float32 rounding."""
    from audio_diffusion_torch.ops.unet import group_norm

    rs = np.random.default_rng(5)
    x = torch.from_numpy(rs.standard_normal((2, 3000, 16)).astype(
        np.float32) * 3 + 1).to(cuda_device)
    scale = torch.from_numpy(rs.standard_normal(16).astype(np.float32)).to(
        cuda_device)
    bias = torch.zeros(16, device=cuda_device)
    with torch.no_grad():
        got = group_norm(x, 8, scale, bias)
    want = group_norm(x.clone().requires_grad_(True), 8, scale, bias)
    assert (got - want.detach()).abs().max().item() <= 1e-4


# Length-sharded item stages and the DP step over two ranks sharing the card
# over gloo (each a process running this file as a worker, as in
# tests/test_torch_parallel.py). Each shard is a multiple of its level's
# statistics tile (8192 // C rows), so the staged item's statistics and
# output are the unsharded kernel's bits; against the sharded plain version
# the bars are this file's. The DP step: loss rtol 2e-5 against one rank,
# parameters after two Adam steps within 1e-6 where every step's gradient
# exceeds 1e-6 of the gradient norm (tests/test_torch_parallel.py).
SHARDED_SHAPES = [(64, 2048), (256, 512)]
SHARDED_DTYPES = [torch.float32, torch.bfloat16]
DP_CFG = dict(in_channels=2, channels=[8, 32, 256], factors=[1, 4, 2],
              items=[1, 1, 1], attentions=[0, 0, 1], attention_heads=4,
              attention_features=8, modulation_features=64, resnet_groups=4)


def dp_steps(params0, x, mesh=None):
    """Two Adam steps of the DP_CFG net on the card from ``params0``:
    (losses, grad norms, parameters, each step's gradients)."""
    from test_torch_parallel import RecordingAdam, adam

    model = DiffusionModel(net_t=UNetV0, **DP_CFG)
    with torch.no_grad():
        for k, p in model.params.items():
            p.copy_(params0[k])
    seen = RecordingAdam.seen = []
    init, step = make_train_step(model.loss, adam(recording=True), mesh=mesh)
    state = init(model.params, torch.Generator(device="cuda").manual_seed(7))
    losses, norms = [], []
    for _ in range(2):
        state, m = step(state, x)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return losses, norms, {k: v.detach().cpu() for k, v in
                           state.params.items()}, [[g.cpu() for g in s]
                                                   for s in seen]


def sharded_worker(rank, port, root):
    from test_torch_parallel import join_group

    from audio_diffusion_torch.ops.kernels.resnet import (
        _launch_forward, _launch_sharded, resnet_item_sharded_reference)
    from audio_diffusion_torch.parallel import comm, create_mesh, shard_batch

    join_group(rank, port)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = create_mesh(backend="gloo")
    shard = comm.group_shard(mesh.get_group("data"))
    items = []
    for c, length in SHARDED_SHAPES:
        for dtype in SHARDED_DTYPES:
            args = item_inputs(c, length, 1, c, dtype, "cuda")
            x, params = args[0], tuple(args[1:])
            part = length // 2
            local = x[:, rank * part:(rank + 1) * part].contiguous()
            with torch.inference_mode():
                got, stats = _launch_sharded(local, params, GROUPS, 1e-5,
                                             True, shard, keep_stats=True)
                ref = resnet_item_sharded_reference(local, *params,
                                                    shard=shard,
                                                    groups=GROUPS)
                full, _, _, full_stats = _launch_forward(
                    x, params, GROUPS, 1e-5, True, keep=True)
            items.append(dict(
                err=(got.float() - ref.float()).abs().max().item(),
                ymax=ref.float().abs().max().item(),
                output_bit_equal=torch.equal(
                    got, full[:, rank * part:(rank + 1) * part]),
                stats_bit_equal=torch.equal(stats, full_stats)))
    base = DiffusionModel(net_t=UNetV0, seed=1, **DP_CFG)
    with torch.no_grad():
        for p in base.params.values():
            if not p.any():
                p.normal_(0.0, 0.02, generator=base.generator)
    params0 = {k: v.detach().clone() for k, v in base.params.items()}
    x = torch.randn(4, 2, 256, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    torch.save(dict(items=items, one=dp_steps(params0, x),
                    dp=dp_steps(params0, shard_batch(x, mesh), mesh)),
               root / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks_on_card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pathlib import Path

    from test_torch_parallel import spawn

    return spawn(Path(__file__), tmp_path_factory.mktemp("ranks"),
                 timeout=600)


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(SHARDED_SHAPES)
                                        * len(SHARDED_DTYPES)))
def test_sharded_item_stages_match_plain(two_ranks_on_card, index):
    dtype = SHARDED_DTYPES[index % len(SHARDED_DTYPES)]
    for rank in two_ranks_on_card:
        r = rank["items"][index]
        bound = 2e-4 if dtype == torch.float32 else 2.0 ** -6 * r["ymax"]
        assert r["err"] <= bound, (r, bound)
        assert r["output_bit_equal"] and r["stats_bit_equal"], r


@pytest.mark.cuda
def test_two_rank_dp_step_on_card_matches_one_rank(two_ranks_on_card):
    for rank in two_ranks_on_card:
        losses, norms, want, grads = rank["one"]
        got_losses, got_norms, got, _ = rank["dp"]
        np.testing.assert_allclose(got_losses, losses, rtol=2e-5)
        np.testing.assert_allclose(got_norms, norms, rtol=2e-5)
        for i, (name, w) in enumerate(want.items()):
            clear = torch.stack([g[i].abs() > 1e-6 * n
                                 for g, n in zip(grads, norms)]).all(0)
            diff = (got[name] - w).abs()
            assert diff[clear].max().item() <= 1e-6, name
            assert diff.max().item() <= 2 * 1e-4 * 2, name
    assert two_ranks_on_card[0]["dp"][0] == two_ranks_on_card[1]["dp"][0]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    from pathlib import Path

    sharded_worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
