"""The port's task models (``DiffusionUpsampler``, ``DiffusionVocoder``,
``DiffusionAE`` with ``MelEncoder1d``, and a net behind ``LTPlugin``)
against the JAX package's, on the tiny configs of
tests/test_task_models.py. Each model's whole parameter tree is a seeded
numpy tree in the JAX layout (every leaf random, so zero-initialized gates
carry signal), carried across by ``params_from_jax``; where JAX draws from
its keys, the test draws the same arrays and feeds them to the port (the
sampler's noise through ``diffusion.noise.normal``, the loss's σ and noise
through ``v_loss``).

Bars (float32): the loss rel 1e-3 and every gradient within 1e-3 of its
leaf's largest value (plus 1e-6·grad_norm: a bias that a one-channel-per-
group GroupNorm removes has a gradient of rounding noise only); a few-step
sample max-abs 1e-3 (the bar of tests/test_parity_full_model.py); the
encoder's latent max-abs 1e-4·max|y|; the round trip of each whole tree
bit-equal and strict both ways.

In bfloat16 the encoder's fused items round where the Pallas kernel
rounds (GroupNorm in f32, scale and bias applied in f32), and JAX's lax
``ResnetItem`` rounds the normalized value and applies the scale and bias
in bf16; with a bf16 conv and GroupNorm around them the latents then
differ by a few bf16 ulps: measured max-abs 0.0078 of max|y| 0.94 (tanh
keeps |y| < 1), bound 0.03.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import DiffusionAE as JaxDiffusionAE
from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu import DiffusionUpsampler as JaxDiffusionUpsampler
from audio_diffusion_tpu import DiffusionVocoder as JaxDiffusionVocoder
from audio_diffusion_tpu import LTPlugin as JaxLTPlugin
from audio_diffusion_tpu import MelEncoder1d as JaxMelEncoder1d
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_tpu.utils import closest_power_2 as jax_closest_power_2
from audio_diffusion_torch import (DiffusionAE, DiffusionModel,
                                   DiffusionUpsampler, DiffusionVocoder,
                                   LTPlugin, MelEncoder1d, UNetV0,
                                   params_from_jax, params_to_jax)
from audio_diffusion_torch.diffusion.vdiffusion import v_loss
from audio_diffusion_torch.utils import closest_power_2
from test_torch_samplers_more import feed

torch.set_num_threads(2)

TINY_NET = dict(channels=[8, 32, 64], factors=[1, 4, 2], items=[1, 1, 1],
                modulation_features=64)
VOCODER = dict(mel_channels=16, mel_n_fft=128, mel_sample_rate=16000,
               mel_normalize_log=True, **TINY_NET)
ENCODER = dict(in_channels=2, channels=32, out_channels=4, factors=[2],
               num_blocks=[1], mel_channels=16, mel_n_fft=64,
               mel_sample_rate=16000)
AE = dict(in_channels=2, inject_depth=2, channels=[8, 16, 32],
          factors=[1, 4, 8], items=[1, 1, 1], modulation_features=32)
LT = dict(num_filters=4, window_length=8, stride=4)
LT_NET = dict(in_channels=2, channels=[16, 32], factors=[1, 2], items=[1, 1],
              modulation_features=32)
STEPS = 3


def seeded_tree(shapes, seed):
    """A tree of ``shapes`` (a ``jax.eval_shape`` result) with seeded
    values of about the initializers' scale."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        a = rs.randn(*s.shape)
        if "freqs" in name:
            a = a * 16.0
        elif "scale" in name:
            a = 1.0 + 0.1 * a
        elif len(s.shape) == 3:  # conv kernels [K, Cin, Cout]
            a = a / np.sqrt(s.shape[0] * s.shape[1])
        elif len(s.shape) == 2:
            a = a / np.sqrt(s.shape[0])
        else:
            a = 0.1 * a
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def load(model, state):
    """Every parameter of the port's task model from ``state`` (strict)."""
    net, extras = model.split_params(state)
    model.net.module.load_state_dict(net, strict=True)
    for prefix, module in model.extras.items():
        module.load_state_dict(extras[prefix], strict=True)


def make_pair(jax_model, model, x, seed):
    shapes = jax.eval_shape(
        lambda: jax_model.init_params(jax.random.key(0), jnp.asarray(x)))
    tree = seeded_tree(shapes, seed)
    jax_model.params = tree
    load(model, params_from_jax(tree))
    return jax_model, tree, model


def audio(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def upsampler():
    x = audio(0, 1, 2, 256)
    return make_pair(
        JaxDiffusionUpsampler(net_t=JaxUNetV0, in_channels=2,
                              upsample_factor=4, **TINY_NET),
        DiffusionUpsampler(net_t=UNetV0, in_channels=2, upsample_factor=4,
                           device="cpu", **TINY_NET), x, seed=1)


@pytest.fixture(scope="module")
def vocoder():
    x = audio(0, 1, 2, 1024)
    return make_pair(JaxDiffusionVocoder(net_t=JaxUNetV0, **VOCODER),
                     DiffusionVocoder(net_t=UNetV0, device="cpu", **VOCODER),
                     x, seed=2)


@pytest.fixture(scope="module")
def autoencoder():
    x = audio(0, 1, 2, 1024)
    return make_pair(
        JaxDiffusionAE(net_t=JaxUNetV0, encoder=JaxMelEncoder1d(**ENCODER),
                       **AE),
        DiffusionAE(net_t=UNetV0, encoder=MelEncoder1d(device="cpu",
                                                       **ENCODER),
                    device="cpu", **AE), x, seed=3)


@pytest.fixture(scope="module")
def lt_model():
    x = audio(0, 1, 2, 256)
    return make_pair(
        JaxDiffusionModel(net_t=JaxLTPlugin(JaxUNetV0, **LT), **LT_NET),
        DiffusionModel(net_t=LTPlugin(UNetV0, **LT), device="cpu", **LT_NET),
        x, seed=4)


def jax_loss_and_draws(jax_model, tree, x, x_net_shape, key):
    """JAX's loss and gradient tree at ``key``, and the σ and noise its
    VDiffusion drew there for a net input of ``x_net_shape``."""
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_model.loss(p, key, jnp.asarray(x))))(tree)
    key_sigma, key_noise, _ = jax.random.split(key, 3)
    sigmas = jax.random.uniform(key_sigma, (x_net_shape[0],))
    noise = jax.random.normal(key_noise, x_net_shape)
    return float(loss), grads, np.asarray(sigmas), np.asarray(noise)


def check_loss_and_gradients(pair, monkeypatch, x, x_net_shape):
    """The port's loss through the model (reupsampling, folding, encoding)
    at JAX's σ and noise, and the gradients of every parameter, the
    extras' included."""
    jax_model, tree, model = pair
    want, grads_j, sigmas, noise = jax_loss_and_draws(
        jax_model, tree, x, x_net_shape, jax.random.key(6))

    def fixed(params, generator, x_net, **kwargs):
        return v_loss(model.net, params, x_net, torch.from_numpy(sigmas),
                      torch.from_numpy(noise), **kwargs)

    monkeypatch.setattr(model.diffusion, "loss", fixed)
    params = model.params
    loss = model.loss(params, torch.Generator(), torch.from_numpy(x))
    assert loss.item() == pytest.approx(want, rel=1e-3)
    grads_t = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))
    grads_j = params_from_jax(grads_j)
    assert set(grads_j) == set(grads_t)
    norm = torch.sqrt(sum(g.square().sum() for g in grads_j.values())).item()
    for name, g in grads_t.items():
        scale = grads_j[name].abs().max().item()
        err = (g - grads_j[name]).abs().max().item()
        assert err <= 1e-3 * scale + 1e-6 * norm, (name, err, scale)
    return grads_t


def check_round_trip(pair):
    """The whole tree crosses both ways bit for bit, and a leftover leaf
    raises in each direction."""
    _, tree, model = pair
    state = params_from_jax(tree)
    assert set(state) == set(model.params)
    back = params_to_jax(state)
    back = back if "net" in back else {"net": back}
    flat_a = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_a.keys() == flat_b.keys()
    for path, a in flat_a.items():
        np.testing.assert_array_equal(np.asarray(a), flat_b[path])
    with pytest.raises(ValueError, match="stray"):
        params_from_jax({**tree, "stray": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="params_to_jax"):
        params_to_jax({**state, "stray.kernel": torch.zeros(1)})


def test_upsampler_loss_and_gradients(upsampler, monkeypatch):
    x = audio(7, 2, 2, 256)
    check_loss_and_gradients(upsampler, monkeypatch, x, x.shape)


def test_upsampler_sample(upsampler, monkeypatch):
    jax_model, tree, model = upsampler
    low = audio(8, 1, 2, 64)
    key = jax.random.key(9)
    want = np.asarray(jax_model.sample(jnp.asarray(low), key=key,
                                       num_steps=STEPS))
    feed(monkeypatch, [jax.random.normal(key, (1, 2, 256))])
    got = model.sample(torch.from_numpy(low), num_steps=STEPS).numpy()
    assert got.shape == (1, 2, 256)
    assert np.abs(got - want).max() < 1e-3
    # The conditioning is the ×4 sinc upsampling of the low-rate input.
    assert torch.allclose(model.reupsample(torch.from_numpy(audio(1, 1, 2, 256))),
                          torch.from_numpy(np.asarray(jax_model.reupsample(
                              jnp.asarray(audio(1, 1, 2, 256))))), atol=1e-6)


def test_upsampler_round_trip(upsampler):
    check_round_trip(upsampler)


def test_vocoder_loss_and_gradients(vocoder, monkeypatch):
    """Stereo folds into the batch: the net sees [b·c, 1, t]; ``to_flat``
    has a gradient."""
    x = audio(7, 2, 2, 1024)
    grads = check_loss_and_gradients(vocoder, monkeypatch, x, (4, 1, 1024))
    assert grads["to_flat/kernel"].abs().max() > 0


def test_vocoder_sample(vocoder, monkeypatch):
    jax_model, tree, model = vocoder
    mel = np.asarray(jax_model.to_spectrogram(jnp.asarray(audio(8, 1, 2,
                                                                1024))))
    assert mel.shape == (1, 2, 16, 32)
    got_mel = model.to_spectrogram(torch.from_numpy(audio(8, 1, 2, 1024)))
    assert np.abs(got_mel.numpy() - mel).max() <= 1e-5 * np.abs(mel).max()
    key = jax.random.key(9)
    want = np.asarray(jax_model.sample(jnp.asarray(mel), key=key,
                                       num_steps=STEPS))
    feed(monkeypatch, [jax.random.normal(key, (2, 1, 1024))])
    got = model.sample(torch.from_numpy(mel), num_steps=STEPS).numpy()
    assert got.shape == (1, 2, 1024)
    assert np.abs(got - want).max() < 1e-3


def test_vocoder_round_trip(vocoder):
    check_round_trip(vocoder)


def test_autoencoder_loss_and_gradients(autoencoder, monkeypatch):
    """The encoder trains jointly: every one of its parameters has a
    gradient, as in JAX; ``channels=`` is the model's own."""
    x = audio(7, 2, 2, 1024)
    grads = check_loss_and_gradients(autoencoder, monkeypatch, x, x.shape)
    enc = [k for k in grads if k.startswith("encoder/")]
    assert len(enc) == 8 + 2 * 4 and all(grads[k].abs().max() > 0
                                         for k in enc)
    _, _, model = autoencoder
    with pytest.raises(ValueError, match="channels"):
        model.loss(model.params, torch.Generator(), torch.zeros(1, 2, 1024),
                   channels=[None])


def test_autoencoder_latent_matches_encoder_apply(autoencoder):
    jax_model, tree, model = autoencoder
    x = audio(10, 2, 2, 1024)
    want = np.asarray(jax_model.encoder.apply(tree["encoder"],
                                              jnp.asarray(x)))
    got, info = model.encode(torch.from_numpy(x), with_info=True)
    assert info == {} and got.shape == (2, 4, 32)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_autoencoder_bf16_encoder_gap(autoencoder):
    """bf16 on both sides, the same weights: the fused items' rounding
    against the lax ResnetItem's (see the module docstring)."""
    x = audio(11, 1, 2, 1024)
    jax_enc = JaxMelEncoder1d(dtype=jnp.bfloat16, **ENCODER)
    shapes = jax.eval_shape(lambda: jax_enc.init(jax.random.key(0),
                                                 jnp.asarray(x)))
    tree = seeded_tree(shapes, 12)
    want = np.asarray(jax_enc.apply(tree, jnp.asarray(x)).astype(
        jnp.float32))
    enc = MelEncoder1d(dtype=torch.bfloat16, device="cpu", **ENCODER)
    state = params_from_jax({"net": autoencoder[1]["net"], "encoder": tree})
    enc.load_state_dict({k.split("/", 1)[1]: v for k, v in state.items()
                         if k.startswith("encoder/")}, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 0.03


def test_autoencoder_decode(autoencoder, monkeypatch):
    """``decode`` samples closest_power_2(L · latent_factor) samples (which
    may round down) from noise in the latent's dtype."""
    jax_model, tree, model = autoencoder
    latent = np.tanh(audio(13, 1, 4, 32))
    key = jax.random.key(14)
    want = np.asarray(jax_model.decode(jnp.asarray(latent), key=key,
                                       num_steps=STEPS))
    feed(monkeypatch, [jax.random.normal(key, (1, 2, 1024))])
    got = model.decode(torch.from_numpy(latent), num_steps=STEPS).numpy()
    assert got.shape == want.shape == (1, 2, 1024)
    assert np.abs(got - want).max() < 1e-3
    with pytest.raises(ValueError, match="channels"):
        model.decode(torch.from_numpy(latent), num_steps=1, channels=[None])


@pytest.mark.parametrize("x", [1, 3, 768, 1000, 1536, 1537, 2**18 + 1, 0.7])
def test_closest_power_2_matches_jax(x):
    """The decode length's rounding, down on a tie (768 -> 512)."""
    assert closest_power_2(x) == jax_closest_power_2(x)


def test_autoencoder_round_trip(autoencoder):
    check_round_trip(autoencoder)


def test_lt_plugin_loss_and_gradients(lt_model, monkeypatch):
    x = audio(7, 2, 2, 256)
    grads = check_loss_and_gradients(lt_model, monkeypatch, x, x.shape)
    assert grads["encode.kernel"].abs().max() > 0
    assert grads["decode.kernel"].abs().max() > 0


def test_lt_plugin_sample(lt_model):
    jax_model, tree, model = lt_model
    x = audio(15, 1, 2, 256)
    want = np.asarray(jax_model.sample(jnp.asarray(x), num_steps=STEPS))
    got = model.sample(torch.from_numpy(x), num_steps=STEPS).numpy()
    assert np.abs(got - want).max() < 1e-3


def test_lt_plugin_round_trip(lt_model):
    check_round_trip(lt_model)


def test_task_params_save_load_and_initialize(vocoder, tmp_path):
    """``save``/``load`` and ``initialize`` cover the extras; a train step's
    parameters are the net's and ``to_flat``'s."""
    _, _, model = vocoder
    path = tmp_path / "voc.pt"
    model.save(path)
    before = {k: v.detach().clone() for k, v in model.params.items()}
    model.initialize(torch.zeros(1, 2, 1024),
                     generator=torch.Generator().manual_seed(3))
    assert not torch.equal(model.params["to_flat/kernel"],
                           before["to_flat/kernel"])
    model.load(path)
    for name, t in model.params.items():
        assert torch.equal(t, before[name]), name
    with pytest.raises(ValueError, match="no module"):
        model.split_params({"encoder/x": torch.zeros(1)})
