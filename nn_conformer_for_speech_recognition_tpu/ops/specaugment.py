"""SpecAugment — fully on-device, vectorized over the batch.

The reference implements SpecAugment with per-utterance Python loops and a CPU
round-trip inside time-warping (``x.cpu().numpy()`` at
`lib/standard/asrnn.py:117`) and a frequency mask that accidentally reuses the
same rows for every batch element (`asrnn.py:140-141`).  Here every policy is
pure jnp driven by PRNG keys, ``vmap``-ed over the batch, and jit-fuses into
the training step — masks are generated on the VPU, no host sync.

Policies (parameters per `lib/hparams.py:85-95`):
  * time warp, W (`asrnn.py:91-125`) — linear-interp warp around a random
    center, stretch by w ∈ [-W, W].
  * frequency masking, F × n (`asrnn.py:127-144`).
  * time masking, T × Mt with adaptive multiplicity Mt=min(Mt, floor(pm·tau))
    and adaptive size T=floor(ps·tau) (`asrnn.py:146-192`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from nn_conformer_for_speech_recognition_tpu.config import SpecAugmentConfig


def _time_warp_single(x: jnp.ndarray, tau: jnp.ndarray, key: jax.Array, w_param: int):
    """Warp the time axis of one utterance (T, F) within its valid length."""
    t = x.shape[0]
    if w_param <= 0:
        return x
    k1, k2 = jax.random.split(key)
    tau_f = tau.astype(jnp.float32)
    # warp center w0 ∈ [W, tau-W); degenerate (tau <= 2W) → identity
    lo = jnp.float32(w_param)
    hi = jnp.maximum(tau_f - w_param, lo + 1.0)
    w0 = jnp.floor(jax.random.uniform(k1, (), minval=lo, maxval=hi))
    w = jnp.round(
        jax.random.uniform(k2, (), minval=-float(w_param), maxval=float(w_param))
    )
    valid = tau_f > 2.0 * w_param + 1.0
    w = jnp.where(valid, w, 0.0)

    pos = jnp.arange(t, dtype=jnp.float32)
    pivot = w0 + w
    # piecewise-linear source coordinate
    left = pos * (w0 / jnp.maximum(pivot, 1.0))
    right = w0 + (pos - pivot) * ((tau_f - 1.0 - w0) / jnp.maximum(tau_f - 1.0 - pivot, 1.0))
    src = jnp.where(pos <= pivot, left, right)
    src = jnp.clip(src, 0.0, tau_f - 1.0)
    src = jnp.where(pos < tau_f, src, pos)  # identity in padding (after clip)

    i0 = jnp.floor(src).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, t - 1)
    frac = (src - i0.astype(jnp.float32))[:, None]
    # linear interp as a (T, T) one-hot matmul instead of x[i0]/x[i1]
    # batched gathers: the interp matrix is one matmul and fuses.
    j = jnp.arange(t)[None, :]
    interp = (j == i0[:, None]) * (1.0 - frac) + (j == i1[:, None]) * frac
    return jax.lax.dot(
        interp.astype(x.dtype), x, precision=jax.lax.Precision.HIGHEST
    )


def _mask_axis_single(
    x: jnp.ndarray,
    key: jax.Array,
    axis_size: jnp.ndarray,
    max_width: jnp.ndarray,
    n_masks: int,
    active_masks: jnp.ndarray,
    axis: int,
    mask_value: float,
):
    """Apply up to n_masks random contiguous masks along ``axis`` of (T, F)."""
    size = x.shape[axis]
    coords = jnp.arange(size)
    keys = jax.random.split(key, n_masks)

    def one_mask(k):
        kw, kp = jax.random.split(k)
        width = jax.random.randint(kw, (), 0, jnp.maximum(max_width, 1) + 1)
        start = jax.random.randint(
            kp, (), 0, jnp.maximum(axis_size - width, 0) + 1
        )
        return (coords >= start) & (coords < start + width)

    masks = jax.vmap(one_mask)(keys)  # (n_masks, size)
    masks = masks & (jnp.arange(n_masks)[:, None] < active_masks)
    mask = jnp.any(masks, axis=0)
    shape = [1, 1]
    shape[axis] = size
    return jnp.where(mask.reshape(shape), jnp.float32(mask_value), x)


def _specaugment_single(
    x: jnp.ndarray, tau: jnp.ndarray, key: jax.Array, cfg: SpecAugmentConfig
):
    n_mels = x.shape[1]
    k_warp, k_freq, k_time = jax.random.split(key, 3)

    # 1) time warp ×W n times
    for i in range(cfg.time_warp_n):
        x = _time_warp_single(x, tau, jax.random.fold_in(k_warp, i), cfg.time_warp_w)

    # 2) frequency masking, F × n (independent rows per batch element, fixing
    #    the reference's shared-rows bug asrnn.py:140-141)
    x = _mask_axis_single(
        x, k_freq, jnp.int32(n_mels), jnp.int32(cfg.freq_mask_f),
        cfg.freq_mask_n, jnp.int32(cfg.freq_mask_n), axis=1,
        mask_value=cfg.mask_value,
    )

    # 3) time masking with adaptive policies (asrnn.py:146-192)
    t_param = jnp.int32(cfg.time_mask_t)
    if cfg.adaptive_size:
        t_param = jnp.floor(cfg.ps * tau.astype(jnp.float32)).astype(jnp.int32)
    mt = jnp.int32(cfg.time_mask_n)
    if cfg.adaptive_multiplicity:
        mt = jnp.minimum(
            mt, jnp.floor(cfg.pm * tau.astype(jnp.float32)).astype(jnp.int32)
        )
    x = _mask_axis_single(
        x, k_time, tau, t_param, cfg.time_mask_n, mt, axis=0,
        mask_value=cfg.mask_value,
    )
    return x


@partial(jax.jit, static_argnames=("cfg",))
def specaugment(
    features: jnp.ndarray,
    frame_lengths: jnp.ndarray,
    key: jax.Array,
    cfg: SpecAugmentConfig,
) -> jnp.ndarray:
    """Apply SpecAugment to a batch.

    Args:
        features: (B, T, n_mels) log-mel features.
        frame_lengths: (B,) valid frame counts.
        key: PRNG key (one per step; split per example internally).

    Returns:
        augmented (B, T, n_mels).
    """
    b = features.shape[0]
    keys = jax.random.split(key, b)
    return jax.vmap(lambda x, tau, k: _specaugment_single(x, tau, k, cfg))(
        features, frame_lengths, keys
    )


def add_gaussian_noise(
    audio: jnp.ndarray, key: jax.Array, std: float = 0.01
) -> jnp.ndarray:
    """Waveform-level gaussian noise, the reference's ``add_augmentations``
    balanced-data path (`lib/standard/speechcommands.py:227-252`)."""
    return audio + std * jax.random.normal(key, audio.shape, audio.dtype)
