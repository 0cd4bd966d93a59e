"""Convolutional subsampling frontend.

The reference stacks two strided Conv2d over the (1, n_mels, T) spectrogram
"image" (512ch k=7 s=2 → 128ch k=3 s=2, `lib/convsubsampling.py:5-47`,
`lib/hparams.py:46-51`), then *flattens the whole utterance* through a
fixed-``max_len`` Linear (`lib/standard/asrnn.py:28,206-209`) — a
length-generalisation bug we deliberately do not replicate (SURVEY.md §7).

Here the convs are time-preserving (stride 2 in time each → 4× reduction,
SAME padding so subsampled_length = ceil(ceil(T/2)/2)), and a per-frame Dense
projects the flattened frequency×channel axis to ``d_model``.  The layout
is NHWC (channels last).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from nn_conformer_for_speech_recognition_tpu.config import SubsamplingConfig
from nn_conformer_for_speech_recognition_tpu.models import layers as nn


class ConvSubsampling(nn.Module):
    """(B, T, n_mels) → (B, ceil(T/4), d_model), with length bookkeeping."""

    config: SubsamplingConfig
    d_model: int
    dtype: jnp.dtype = jnp.float32

    def __call__(
        self, x: jnp.ndarray, frame_lengths: Optional[jnp.ndarray] = None
    ) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
        cfg = self.config
        # (B, T, F) → (B, T, F, 1) as NHWC with time as H, mel bins as W
        h = x[..., None].astype(self.dtype)
        for ch, k, st, sf in zip(
            cfg.channels, cfg.kernel_sizes, cfg.time_strides, cfg.freq_strides
        ):
            h = nn.Conv(
                features=ch,
                kernel_size=(k, k),
                strides=(st, sf),
                padding="SAME",
                dtype=self.dtype,
            )(h)
            h = jax.nn.relu(h)
        b, t, f, c = h.shape
        h = h.reshape(b, t, f * c)
        h = nn.Dense(self.d_model, dtype=self.dtype)(h)

        out_lengths = None
        if frame_lengths is not None:
            out_lengths = frame_lengths
            for st in cfg.time_strides:
                out_lengths = -(-out_lengths // st)
        return h, out_lengths
