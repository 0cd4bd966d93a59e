"""Log-mel spectrogram featurization, on the device.

Replaces the reference's per-clip CPU librosa loop
(`lib/standard/speechcommands.py:103-124`: ``librosa.feature.melspectrogram``
with n_mels=40 at ~125 clips/s, plus per-utterance min-max normalisation) with
a batched, jit-compiled pipeline that runs on-device:

    audio (B, S) → frames (B, T, n_fft) → |rFFT|^2 → mel matmul → log → norm

The rFFT is expressed as two matmuls against a precomputed DFT basis
(n_fft ≤ 512 keeps them small, SURVEY.md §7 "Hard parts"); the mel
projection is one more matmul, and XLA fuses the elementwise work between
them.

Mel filterbank construction follows the Slaney formulation (librosa default)
so parity configs reproduce the reference's feature values.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nn_conformer_for_speech_recognition_tpu.config import FeatureConfig


# ---------------------------------------------------------------------------
# Filterbank / window construction (host-side numpy; hashable, cached)
# ---------------------------------------------------------------------------


def hz_to_mel(f: np.ndarray, htk: bool = False) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mels = np.where(above, min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz(m: np.ndarray, htk: bool = False) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    freqs = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=16)
def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float, htk: bool = False
) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, shape (n_fft//2+1, n_mels)."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)  # (n_mels+2, n_bins)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    fb = np.maximum(0.0, np.minimum(lower, upper))  # (n_mels, n_bins)
    # Slaney area normalisation
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm.reshape(-1, 1)
    return fb.T.astype(np.float32)  # (n_bins, n_mels)


@functools.lru_cache(maxsize=16)
def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window, zero-padded (centered) to n_fft."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    if win_length < n_fft:
        pad = n_fft - win_length
        w = np.pad(w, (pad // 2, pad - pad // 2))
    return w.astype(np.float32)


@functools.lru_cache(maxsize=16)
def dft_basis(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT basis matrices, each (n_fft, n_fft//2+1).

    ``frames @ real`` and ``frames @ imag`` give Re/Im of the rFFT as two
    matmuls.
    """
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft).reshape(-1, 1)
    k = np.arange(n_bins).reshape(1, -1)
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# ---------------------------------------------------------------------------
# jnp featurization
# ---------------------------------------------------------------------------


def frame_signal(audio: jnp.ndarray, n_fft: int, hop: int) -> jnp.ndarray:
    """Centered framing (librosa semantics): reflect-pad n_fft//2 each side,
    then T = S//hop + 1 frames of length n_fft.

    audio: (B, S) → frames (B, T, n_fft)

    Implemented via ``conv_general_dilated_patches`` (an im2col conv): a
    plain strided window rather than an advanced-indexing gather.
    """
    s = audio.shape[-1]
    num_frames = s // hop + 1
    pad = n_fft // 2
    padded = jnp.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(pad, pad)], mode="reflect")
    # trim so exactly num_frames windows fit: last window starts at
    # (num_frames-1)*hop and spans n_fft samples
    needed = (num_frames - 1) * hop + n_fft
    padded = padded[..., :needed]
    patches = jax.lax.conv_general_dilated_patches(
        padded[:, None, :],  # (B, C=1, S)
        filter_shape=(n_fft,),
        window_strides=(hop,),
        padding="VALID",
    )  # (B, n_fft, T)
    return jnp.moveaxis(patches, 1, 2)


def log_mel_spectrogram(
    audio: jnp.ndarray,
    config: FeatureConfig,
    audio_lengths: Optional[jnp.ndarray] = None,
    use_matmul_dft: bool = True,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Batched log-mel features.

    Args:
        audio: (B, S) float32 waveforms (zero-padded to common length S).
        audio_lengths: optional (B,) sample counts; used for frame-length
            bookkeeping and to mask normalisation statistics.

    Returns:
        (B, T, n_mels) features and (B,) frame lengths (or None).

    Reference behavior reproduced: power-2 mel spectrogram → log with floor →
    per-utterance min-max normalisation (`speechcommands.py:113-119`).
    """
    n_fft, hop = config.n_fft, config.hop_length
    window = jnp.asarray(hann_window(config.win_length_, n_fft))
    mel_fb = jnp.asarray(
        mel_filterbank(config.sample_rate, n_fft, config.n_mels, config.fmin, config.fmax_, config.htk)
    )

    frames = frame_signal(audio, n_fft, hop) * window  # (B, T, n_fft)
    if use_matmul_dft:
        real_b, imag_b = dft_basis(n_fft)
        re = frames @ jnp.asarray(real_b)
        im = frames @ jnp.asarray(imag_b)
        power = re * re + im * im
    else:
        spec = jnp.fft.rfft(frames, n=n_fft, axis=-1)
        power = jnp.abs(spec) ** 2
    mel = power @ mel_fb  # (B, T, n_mels)
    logmel = jnp.log(jnp.maximum(mel, config.log_floor))

    frame_lengths = None
    if audio_lengths is not None:
        frame_lengths = audio_lengths // hop + 1

    logmel = normalize_features(logmel, config.normalize, frame_lengths)
    return logmel, frame_lengths


def normalize_features(
    feats: jnp.ndarray, mode: str, frame_lengths: Optional[jnp.ndarray] = None
) -> jnp.ndarray:
    """Per-utterance normalisation over valid frames.

    'minmax' replicates `speechcommands.py:117-119`; 'meanvar' is standard
    CMVN; 'none' passes through.
    """
    if mode == "none":
        return feats
    if frame_lengths is not None:
        t = feats.shape[-2]
        mask = (jnp.arange(t)[None, :, None] < frame_lengths[:, None, None])
    else:
        mask = jnp.ones_like(feats, dtype=bool)

    if mode == "minmax":
        big = jnp.finfo(feats.dtype).max
        mn = jnp.min(jnp.where(mask, feats, big), axis=(-2, -1), keepdims=True)
        mx = jnp.max(jnp.where(mask, feats, -big), axis=(-2, -1), keepdims=True)
        out = (feats - mn) / jnp.maximum(mx - mn, 1e-8)
    elif mode == "meanvar":
        denom = jnp.maximum(jnp.sum(mask, axis=(-2, -1), keepdims=True), 1)
        mean = jnp.sum(jnp.where(mask, feats, 0.0), axis=(-2, -1), keepdims=True) / denom
        var = jnp.sum(jnp.where(mask, (feats - mean) ** 2, 0.0), axis=(-2, -1), keepdims=True) / denom
        out = (feats - mean) * jax.lax.rsqrt(var + 1e-8)
    else:
        raise ValueError(f"unknown normalize mode {mode!r}")
    return jnp.where(mask, out, 0.0)


def make_featurizer(config: FeatureConfig):
    """Returns a jitted (audio, lengths) -> (features, frame_lengths) fn."""

    @jax.jit
    def featurize(audio, audio_lengths=None):
        return log_mel_spectrogram(audio, config, audio_lengths)

    return featurize
