"""The port's DSP front end (``audio_diffusion_torch.dsp``: sinc
resampling, STFT and its inverse, Griffin-Lim, the mel filterbank and
``MelSpectrogram``) against the JAX package's on the same numpy inputs.

Bar: float32, max-abs ≤ 1e-5·max(1, max|y|) (pocketfft in both, summed in
other orders; measured ≤ 6e-7). The inverse STFT divides by the summed
squared window, which falls to about 1e-6 over the first and last samples
of a signal: there both packages divide their FFTs' rounding by it, so the
bar there is scaled by 1 / Σ window² (measured 5.6e-5 at a sample where
Σ window² is 1.2e-6, against 4.8e-7 in the interior).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import dsp as jax_dsp
from audio_diffusion_torch import dsp
from audio_diffusion_torch.dsp.mel import _framing_window

torch.set_num_threads(2)


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def assert_close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rel * scale


@pytest.mark.parametrize("factor_in,factor_out", [(2, 1), (1, 2), (3, 2),
                                                  (2, 3), (16, 1), (1, 16)])
def test_resample_matches_jax(factor_in, factor_out):
    x = rand(factor_in * 10 + factor_out, 2, 2, 1000)
    got = dsp.resample(torch.from_numpy(x), factor_in, factor_out)
    want = jax_dsp.resample(jnp.asarray(x), factor_in, factor_out)
    assert got.shape[-1] == int(factor_out * 1000 / factor_in)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("factor", [2, 16])
def test_downsample_upsample_match_jax(factor):
    x = rand(factor, 1, 2, 1024)
    down = dsp.downsample(torch.from_numpy(x), factor)
    assert_close(down.numpy(), jax_dsp.downsample(jnp.asarray(x), factor))
    up = dsp.upsample(down, factor)
    assert up.shape == (1, 2, 1024)
    assert_close(up.numpy(), jax_dsp.upsample(jnp.asarray(down.numpy()),
                                              factor))


def test_resample_interleaves_phases():
    """Output sample l·factor + k is frame l's phase k: an impulse upsampled
    ×4 puts the sinc's centre tap at 4·n exactly (phase 0 is the identity
    tap, scaled by the rolloff)."""
    x = np.zeros((1, 1, 64), np.float32)
    x[..., 20] = 1.0
    y = dsp.upsample(torch.from_numpy(x), 4)[0, 0].numpy()
    assert y.shape == (256,)
    assert np.argmax(np.abs(y)) == 80


@pytest.mark.parametrize("n_fft,hop,win", [(128, 32, 128), (128, 32, 96),
                                           (64, 16, 40)])
def test_stft_matches_jax(n_fft, hop, win):
    x = rand(n_fft + win, 3, 700)
    got = dsp.stft(torch.from_numpy(x), n_fft, hop, win)
    want = jax_dsp.stft(jnp.asarray(x), n_fft, hop, win)
    assert got.shape == (3, n_fft // 2 + 1, 1 + (700 - n_fft) // hop)
    assert_close(got.numpy(), want)


def test_stft_needs_a_full_frame():
    with pytest.raises(ValueError, match="shorter than n_fft"):
        dsp.stft(torch.zeros(1, 100), 128, 32)


@pytest.mark.parametrize("length", [None, 700, 650, 760])
def test_istft_matches_jax(length):
    """win < n_fft; ``length`` above, at and below the frames' span (the
    frames beyond it dropped, the samples beyond the last frame zero). The
    bar is scaled by 1 / Σ window² where that sum is below 1."""
    n_fft, hop, win = 128, 32, 96
    x = rand(5, 3, 700)
    spec = dsp.stft(torch.from_numpy(x), n_fft, hop, win)
    got = dsp.istft(spec, n_fft, hop, win, length=length).numpy()
    want = np.asarray(jax_dsp.istft(jnp.asarray(spec.numpy()), n_fft, hop,
                                    win, length=length))
    assert got.shape == want.shape
    frames = spec.shape[-1]
    natural = (frames - 1) * hop + n_fft
    wsq = np.zeros(max(natural, length or 0), np.float32)
    w2 = _framing_window(n_fft, win, "cpu").numpy() ** 2
    for f in range(frames):
        wsq[f * hop:f * hop + n_fft] += w2
    wsq = wsq[:got.shape[-1]]
    scale = max(1.0, float(np.abs(want).max()))
    bar = 1e-5 * scale / np.clip(wsq, 1e-11, 1.0)
    assert (np.abs(got - want) <= bar).all()
    # Where the window covers the signal, istft inverts stft.
    n = min(got.shape[-1], 700)
    inner = wsq[:n] >= 0.1
    assert np.abs(got[:, :n] - x[:, :n])[:, inner].max() < 1e-5


def test_griffin_lim_matches_jax():
    n_fft, hop, win = 128, 32, 96
    x = rand(6, 2, 700)
    mag = np.abs(np.asarray(jax_dsp.stft(jnp.asarray(x), n_fft, hop, win)))
    got = dsp.griffin_lim(torch.from_numpy(mag), n_fft, hop, win, n_iter=8,
                          length=700)
    want = jax_dsp.griffin_lim(jnp.asarray(mag), n_fft, hop, win, n_iter=8,
                               length=700)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want)


def test_griffin_lim_keeps_the_trailing_phase():
    """A ``length`` that loses the last frame keeps its previous phase."""
    n_fft, hop = 64, 16
    mag = np.abs(rand(7, 1, 33, 12)) + 0.1
    got = dsp.griffin_lim(torch.from_numpy(mag), n_fft, hop, n_iter=3,
                          length=200)
    want = jax_dsp.griffin_lim(jnp.asarray(mag), n_fft, hop, n_iter=3,
                               length=200)
    assert got.shape == (1, 200)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("n_freqs,n_mels,rate", [(513, 80, 48000),
                                                 (65, 16, 16000),
                                                 (33, 20, 22050)])
def test_melscale_fbanks_match_jax(n_freqs, n_mels, rate):
    got = dsp.melscale_fbanks(n_freqs, n_mels, rate)
    np.testing.assert_array_equal(got, jax_dsp.melscale_fbanks(
        n_freqs, n_mels, rate))
    assert got.dtype == np.float32


@pytest.mark.parametrize("kw", [{}, dict(normalize=True),
                                dict(normalize_log=True),
                                dict(normalize=True, normalize_log=True)])
def test_mel_spectrogram_matches_jax(kw):
    x = rand(8, 2, 2, 1000)
    got = dsp.MelSpectrogram(256, 64, 256, 16000, 20, **kw)(
        torch.from_numpy(x))
    want = jax_dsp.MelSpectrogram(256, 64, 256, 16000, 20, **kw)(
        jnp.asarray(x))
    assert got.shape == (2, 2, 20, 15)
    assert_close(got.numpy(), want)


def test_mel_normalize_divides_by_one_global_max():
    """``normalize`` divides by the largest value over the whole batch, not
    per item: with one item ten times louder, the quiet item's mel is its
    own normalized mel at a tenth of the scale."""
    x = rand(9, 2, 1, 1000)
    x[1] *= 10.0
    mel = dsp.MelSpectrogram(256, 64, 256, 16000, 20, normalize=True)
    both = mel(torch.from_numpy(x))
    alone = mel(torch.from_numpy(x[:1]))
    assert both.max().item() == pytest.approx(1.0)
    assert not torch.allclose(both[:1], alone, atol=1e-2)
    assert_close(both.numpy(), jax_dsp.MelSpectrogram(
        256, 64, 256, 16000, 20, normalize=True)(jnp.asarray(x)))


def test_mel_spectrogram_rejects_center():
    with pytest.raises(ValueError, match="center"):
        dsp.MelSpectrogram(256, 64, 256, 16000, 20, center=True)
