"""The flagship ASR model: Conformer encoder + BiLSTM CTC head.

Mirrors the reference ``ASRNN`` (`lib/standard/asrnn.py:22-260`) capability
surface — encoder: ConvSubsampling → Conformer → projection block
(Linear→SiLU→norm, `asrnn.py:73-89`); decoder: BiLSTM (1 layer, 512 hidden,
bidirectional per `lib/hparams.py:78-81`) → dropout → Linear → log_softmax
(`asrnn.py:250-256`) — with the deviations documented in
SURVEY.md §7: time-preserving subsampling instead of the fixed-``max_len``
flatten+Linear (`asrnn.py:28,206-209`), mask-based length handling instead of
row-dropping (`asrnn.py:211-215`), and SpecAugment applied in the train step
(`ops/specaugment.py`) rather than buried in the forward pass.

Shallow LM fusion (``x += lm(...)`` at `asrnn.py:257-258`) is provided by
`models/lm.py` and composed in the eval path.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from nn_conformer_for_speech_recognition_tpu.config import ModelConfig
from nn_conformer_for_speech_recognition_tpu.models import layers as nn
from nn_conformer_for_speech_recognition_tpu.models.conformer import (
    ConformerEncoder,
    MaskedBatchNorm,
    length_mask,
)
from nn_conformer_for_speech_recognition_tpu.models.subsampling import ConvSubsampling
from nn_conformer_for_speech_recognition_tpu.ops import lstm


class BiLSTM(nn.Module):
    """(Bi)directional LSTM over padded sequences (`ops/lstm.lstm_scan`).

    Each direction of layer ``i`` owns ``lstm_{fwd,bwd}_{i}_{w_ih,w_hh,bias}``.
    """

    hidden: int
    num_layers: int = 1
    bidirectional: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
        names = ("fwd", "bwd") if self.bidirectional else ("fwd",)
        four_h = 4 * self.hidden
        for i in range(self.num_layers):
            dirs = [
                (
                    self.param(f"lstm_{n}_{i}_w_ih", jax.nn.initializers.lecun_normal(),
                               (x.shape[-1], four_h)),
                    self.param(f"lstm_{n}_{i}_w_hh", jax.nn.initializers.orthogonal(),
                               (self.hidden, four_h)),
                    self.param(f"lstm_{n}_{i}_bias", jax.nn.initializers.zeros, (four_h,)),
                )
                for n in names
            ]
            x = jnp.concatenate(
                [lstm.lstm_scan(x, w, lengths, reverse=n == "bwd", dtype=self.dtype)
                 for n, w in zip(names, dirs)],
                axis=-1,
            )
        return x.astype(self.dtype)


class ConformerCTC(nn.Module):
    """features (B, T, n_mels) + lengths → log-probs (B, T', V) + lengths'."""

    config: ModelConfig
    vocab_size: int

    @property
    def dtype(self):
        return jnp.dtype(self.config.resolved_compute_dtype())

    def setup(self):
        cfg = self.config
        self.subsampling = ConvSubsampling(
            cfg.subsampling, cfg.encoder.d_model, dtype=self.dtype
        )
        self.encoder = ConformerEncoder(cfg.encoder, remat=cfg.remat, dtype=self.dtype)
        self.input_dropout = nn.Dropout(cfg.encoder.dropout)
        # projection block: Linear → SiLU → masked BN (`asrnn.py:73-89`)
        self.projection = nn.Dense(cfg.decoder.projection_dim, dtype=self.dtype)
        self.projection_norm = MaskedBatchNorm(dtype=self.dtype)
        self.decoder_lstm = BiLSTM(
            cfg.decoder.lstm_hidden,
            num_layers=cfg.decoder.lstm_layers,
            bidirectional=cfg.decoder.bidirectional,
            dtype=self.dtype,
        )
        self.decoder_dropout = nn.Dropout(cfg.decoder.dropout)
        self.final_fc = nn.Dense(self.vocab_size, dtype=jnp.float32)

    def encode(
        self,
        features: jnp.ndarray,
        frame_lengths: jnp.ndarray,
        deterministic: bool = True,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        h, lengths = self.subsampling(features, frame_lengths)
        h = self.input_dropout(h, deterministic=deterministic)
        h = self.encoder(h, lengths, deterministic=deterministic)
        mask = length_mask(lengths, h.shape[1])
        h = jax.nn.silu(self.projection(h))
        h = self.projection_norm(h, mask, use_running_average=deterministic)
        return h * mask[..., None].astype(h.dtype), lengths

    def __call__(
        self,
        features: jnp.ndarray,
        frame_lengths: jnp.ndarray,
        deterministic: bool = True,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        h, lengths = self.encode(features, frame_lengths, deterministic)
        h = self.decoder_lstm(h, lengths)
        h = self.decoder_dropout(h, deterministic=deterministic)
        logits = self.final_fc(h.astype(jnp.float32))
        log_probs = jax.nn.log_softmax(logits, axis=-1)
        return log_probs, lengths


def count_params(params) -> int:
    return sum(int(p.size) for p in jax.tree.leaves(params))
