"""Featurization unit tests: jnp log-mel vs. scipy/numpy references."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

from nn_conformer_for_speech_recognition_tpu.config import FeatureConfig
from nn_conformer_for_speech_recognition_tpu.ops import features as F


def test_hann_window_matches_scipy():
    w = F.hann_window(400, 512)
    ref = scipy.signal.get_window("hann", 400, fftbins=True)
    pad = 512 - 400
    ref = np.pad(ref, (pad // 2, pad - pad // 2))
    np.testing.assert_allclose(w, ref, atol=1e-6)


def test_dft_basis_matches_rfft(rng):
    x = rng.standard_normal((3, 512)).astype(np.float32)
    real_b, imag_b = F.dft_basis(512)
    re, im = x @ real_b, x @ imag_b
    ref = np.fft.rfft(x, axis=-1)
    np.testing.assert_allclose(re, ref.real, atol=2e-2, rtol=1e-4)
    np.testing.assert_allclose(im, ref.imag, atol=2e-2, rtol=1e-4)


def test_mel_filterbank_shape_and_coverage():
    fb = F.mel_filterbank(16000, 512, 40, 0.0, 8000.0)
    assert fb.shape == (257, 40)
    # every filter has positive area; interior bins covered
    assert (fb.sum(axis=0) > 0).all()


def test_frame_signal_centered(rng):
    cfg = FeatureConfig()
    x = rng.standard_normal((2, 16000)).astype(np.float32)
    frames = F.frame_signal(jnp.asarray(x), cfg.n_fft, cfg.hop_length)
    assert frames.shape == (2, 16000 // 512 + 1, 512)
    # frame k starts at k*hop - n_fft//2 in the padded signal; check center
    pad = cfg.n_fft // 2
    padded = np.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    np.testing.assert_allclose(frames[:, 3], padded[:, 3 * 512 : 3 * 512 + 512], atol=1e-6)


def test_logmel_matches_numpy_reference(rng):
    """End-to-end parity with an independent numpy STFT→mel→log pipeline."""
    cfg = FeatureConfig(normalize="none")
    x = rng.standard_normal((2, 16000)).astype(np.float32) * 0.1
    got, _ = F.log_mel_spectrogram(jnp.asarray(x), cfg)

    # numpy reference: centered reflect-pad, hann, rfft, power, mel, log
    pad = cfg.n_fft // 2
    padded = np.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    w = F.hann_window(cfg.n_fft, cfg.n_fft)
    t = 16000 // cfg.hop_length + 1
    frames = np.stack(
        [padded[:, k * cfg.hop_length : k * cfg.hop_length + cfg.n_fft] for k in range(t)],
        axis=1,
    )
    spec = np.fft.rfft(frames * w, axis=-1)
    power = np.abs(spec) ** 2
    mel = power @ F.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, 0.0, 8000.0)
    ref = np.log(np.maximum(mel, cfg.log_floor))

    # f32 matmul-DFT vs f64 numpy rfft: ~1e-2 worst-case in log domain near
    # the noise floor of near-zero mel bins
    np.testing.assert_allclose(np.asarray(got), ref, atol=5e-2, rtol=1e-3)


def _numpy_logmel(x, cfg):
    """Independent numpy STFT → power → mel → log (centered, reflect-pad)."""
    pad = cfg.n_fft // 2
    padded = np.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    w = scipy.signal.get_window("hann", cfg.win_length_, fftbins=True)
    wpad = cfg.n_fft - cfg.win_length_
    w = np.pad(w, (wpad // 2, wpad - wpad // 2))
    t = x.shape[-1] // cfg.hop_length + 1
    frames = np.stack(
        [padded[:, k * cfg.hop_length: k * cfg.hop_length + cfg.n_fft] for k in range(t)],
        axis=1,
    )
    power = np.abs(np.fft.rfft(frames.astype(np.float64) * w, axis=-1)) ** 2
    mel = power @ F.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax_)
    return np.log(np.maximum(mel, cfg.log_floor))


@pytest.mark.parametrize("n_fft,hop,win,n_samples", [
    (512, 512, None, 16001),    # odd length: the last frame is partial
    (512, 512, None, 160000),   # many frames (10 s)
    (512, 160, None, 8000),     # overlapping hop
    (400, 160, 400, 12345),     # n_fft not a power of two
])
def test_logmel_matches_numpy_reference_geometries(rng, n_fft, hop, win, n_samples):
    cfg = FeatureConfig(n_fft=n_fft, hop_length=hop, win_length=win, normalize="none")
    x = rng.standard_normal((2, n_samples)).astype(np.float32) * 0.1
    got, _ = F.make_featurizer(cfg)(jnp.asarray(x))
    ref = _numpy_logmel(x, cfg)
    assert got.shape == ref.shape == (2, n_samples // hop + 1, cfg.n_mels)
    # f32 matmul-DFT vs f64 rfft, compared in the log domain
    np.testing.assert_allclose(np.asarray(got), ref, atol=5e-2, rtol=1e-3)


def test_minmax_normalization_respects_lengths(rng):
    cfg = FeatureConfig(normalize="minmax")
    x = rng.standard_normal((2, 16000)).astype(np.float32)
    lengths = jnp.array([16000, 8000])
    feats, fl = F.log_mel_spectrogram(jnp.asarray(x), cfg, audio_lengths=lengths)
    assert fl is not None and int(fl[0]) == 32 and int(fl[1]) == 16
    f = np.asarray(feats)
    # valid region within [0, 1]; padding region exactly 0
    assert f[1, :16].min() >= -1e-6 and f[1, :16].max() <= 1 + 1e-6
    np.testing.assert_allclose(f[1, 16:], 0.0, atol=1e-6)


def test_featurizer_jit(rng):
    cfg = FeatureConfig()
    fz = F.make_featurizer(cfg)
    x = jnp.asarray(rng.standard_normal((4, 16000)).astype(np.float32))
    feats, fl = fz(x, jnp.full((4,), 16000))
    assert feats.shape == (4, 32, 40)


@pytest.mark.parametrize(
    "sr,nfft,nm,fmin,fmax",
    [(16000, 512, 40, 0.0, 8000.0), (16000, 400, 80, 20.0, 7600.0),
     (8000, 256, 40, 0.0, 4000.0)],
)
def test_mel_filterbank_matches_librosa_equivalent(sr, nfft, nm, fmin, fmax):
    """External (non-self-referential) Slaney filterbank check: compare
    against transformers.audio_utils.mel_filter_bank — HF's independent
    port of librosa.filters.mel (what the reference actually calls,
    `speechcommands.py:113`), numerically equal to librosa."""
    au = pytest.importorskip("transformers.audio_utils")
    ours = F.mel_filterbank(sr, nfft, nm, fmin, fmax)
    ref = au.mel_filter_bank(
        num_frequency_bins=nfft // 2 + 1, num_mel_filters=nm,
        min_frequency=fmin, max_frequency=fmax, sampling_rate=sr,
        norm="slaney", mel_scale="slaney",
    )
    np.testing.assert_allclose(ours, ref, atol=1e-6)
