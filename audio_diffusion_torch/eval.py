"""Sample-quality evaluation metrics (host-side, numpy; a copy of
audio_diffusion_tpu/eval.py, which the port does not import).

- :func:`band_profile` — third-octave log-band energy profile, the coarse
  spectral-envelope signature of a corpus or a sample batch.
- :func:`band_distance` — RMS distance between two profiles. Corpus
  self-distance ~0; white noise vs a music corpus ~0.8.
- :func:`frechet_band_distance` — Fréchet distance between two sets of
  audio in band-profile space.
- :func:`pairwise_diversity` — mean pairwise RMS distance between the
  per-sample profiles of a batch (a collapse detector).
- :func:`log_spectral_distance` — frame-level LSD in dB between two
  waveforms.

All functions take [..., frames] or [channels, frames] float arrays in
[-1, 1]. They evaluate decoded WAVs on the host: a few seconds of audio's
rfft needs no card.
"""
from __future__ import annotations

import numpy as np

__all__ = ["band_profile", "band_distance", "frechet_band_distance",
           "pairwise_diversity", "log_spectral_distance"]


def band_profile(x, sample_rate: int, *, fmin: float = 20.0,
                 bands_per_octave: int = 3) -> np.ndarray:
    """Log mean power per fractional-octave band, averaged over leading dims.

    Returns [num_bands] float64. Bands are geometric from `fmin` up to
    Nyquist (third-octave by default — the psychoacoustic standard grid).
    """
    x = np.asarray(x, np.float32)
    x = x.reshape(-1, x.shape[-1])
    spec = np.abs(np.fft.rfft(x, axis=-1)) ** 2
    freqs = np.fft.rfftfreq(x.shape[-1], 1.0 / sample_rate)
    n_bands = int(np.floor(np.log2(sample_rate / 2 / fmin)
                           * bands_per_octave)) + 1
    edges = fmin * 2 ** (np.arange(n_bands + 1) / bands_per_octave)
    edges = edges[edges <= sample_rate / 2]
    prof = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (freqs >= lo) & (freqs < hi)
        if not m.any():          # short signals: skip empty low bands
            continue
        prof.append(np.log10(spec[:, m].mean() + 1e-12))
    return np.asarray(prof)


def band_distance(profile_a: np.ndarray, profile_b: np.ndarray) -> float:
    """RMS distance between two band profiles (see :func:`band_profile`)."""
    a = np.asarray(profile_a)
    b = np.asarray(profile_b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def frechet_band_distance(ref_samples, gen_samples,
                          sample_rate: int) -> float:
    """Fréchet distance between two SETS of audio in band-profile space.

    Fits a Gaussian (mean + covariance) to each set's per-item
    third-octave profiles and returns the Fréchet/Wasserstein-2 distance
    ``|mu_a - mu_b|^2 + tr(Ca + Cb - 2 (Ca Cb)^{1/2})`` — the FAD recipe
    (Kilgour et al. 2019) with band profiles instead of VGGish
    embeddings (no pretrained network exists in this environment).

    This is the right metric for HETEROGENEOUS corpora, where per-file
    distance to the corpus-mean profile misleads: the mean of diverse
    spectra is broadband, so white noise scores deceptively well while
    real corpus files score badly (measured on the 64-file flagship
    corpus: noise 0.79, real files 1.25). A
    set-level Gaussian accounts for the spread: matching the corpus
    *distribution* (not its mean) is what scores low.

    Needs len(set) comparable to the number of bands for a stable
    covariance; shrinkage (+1e-6 I) keeps small sets finite.
    """
    profs_a = np.stack([band_profile(s, sample_rate)
                        for s in np.asarray(ref_samples, np.float32)])
    profs_b = np.stack([band_profile(s, sample_rate)
                        for s in np.asarray(gen_samples, np.float32)])
    assert profs_a.shape[0] >= 2 and profs_b.shape[0] >= 2, (
        "need >= 2 items per set")
    return _frechet_gaussian(profs_a, profs_b, ridge=1e-6)


def _frechet_gaussian(feats_a: np.ndarray, feats_b: np.ndarray, *,
                      ridge: float = 1e-6,
                      shrinkage: float = 0.0) -> float:
    """Fréchet distance between Gaussians fit to two [n, d] feature sets.

    Shared core of :func:`frechet_band_distance` (band-profile features,
    absolute ``ridge``) and
    :func:`audio_diffusion_torch.embed.frechet_embedding_distance` (learned
    features, relative ``shrinkage`` of the mean variance)."""
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    assert mu_a.shape == mu_b.shape, (mu_a.shape, mu_b.shape)
    ca = np.cov(feats_a, rowvar=False)
    cb = np.cov(feats_b, rowvar=False)
    load = ridge + shrinkage * 0.5 * (np.trace(ca) + np.trace(cb)) \
        / mu_a.shape[0]
    ca = ca + load * np.eye(mu_a.shape[0])
    cb = cb + load * np.eye(mu_a.shape[0])
    # (Ca Cb)^{1/2} via eigendecomposition of the symmetrized product:
    # sqrtm(Ca) Cb sqrtm(Ca) is PSD with the same eigenvalues as Ca Cb.
    wa, va = np.linalg.eigh(ca)
    sqrt_ca = (va * np.sqrt(np.maximum(wa, 0))) @ va.T
    inner = sqrt_ca @ cb @ sqrt_ca
    wi = np.linalg.eigvalsh(inner)
    tr_sqrt = np.sqrt(np.maximum(wi, 0)).sum()
    d2 = float(((mu_a - mu_b) ** 2).sum() + np.trace(ca) + np.trace(cb)
               - 2.0 * tr_sqrt)
    return max(d2, 0.0)


def pairwise_diversity(samples, sample_rate: int) -> float:
    """Mean pairwise band-profile RMS across a batch [n, ..., frames].

    Near-zero means the sampler collapsed to one output; compare against
    the corpus' own pairwise spread for scale.
    """
    samples = np.asarray(samples, np.float32)
    assert samples.ndim >= 2 and samples.shape[0] >= 2, (
        "need a batch of >= 2 samples")
    profs = [band_profile(s, sample_rate) for s in samples]
    n = len(profs)
    dists = [band_distance(profs[i], profs[j])
             for i in range(n) for j in range(i + 1, n)]
    return float(np.mean(dists))


def log_spectral_distance(a, b, *, n_fft: int = 2048,
                          hop: int = 512) -> float:
    """Mean frame-level log-spectral distance in dB between two waveforms.

    LSD = mean_t sqrt(mean_f (10*log10(Pa/Pb))^2) over Hann-windowed STFT
    power frames; identical signals give 0.
    """
    a = np.asarray(a, np.float32).reshape(-1)
    b = np.asarray(b, np.float32).reshape(-1)
    assert a.shape == b.shape, (a.shape, b.shape)
    win = np.hanning(n_fft).astype(np.float32)
    n_frames = 1 + max(0, (len(a) - n_fft)) // hop
    assert n_frames >= 1, f"signal shorter than n_fft={n_fft}"
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    pa = np.abs(np.fft.rfft(a[idx] * win, axis=-1)) ** 2 + 1e-10
    pb = np.abs(np.fft.rfft(b[idx] * win, axis=-1)) ** 2 + 1e-10
    d = 10.0 * np.log10(pa / pb)
    return float(np.mean(np.sqrt(np.mean(d ** 2, axis=-1))))
