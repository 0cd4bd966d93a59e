"""wav2vec-2.0-style contrastive pretraining.

Capability surface of `unused_lib/pretraining/nn.py:7-95` and
`unused_lib/pretraining/loss.py:6-68`:

  * feature encoder = ConvSubsampling over log-mels;
  * target path: linear quantization to target vectors, optionally through a
    Gumbel-softmax quantizer (``gumbel_softmax(tau)`` when not simplified,
    `nn.py:57-70`);
  * context path: random time-step masking (p=0.065 fill with mask_value,
    `nn.py:44-55`) → linear → Conformer context network → BiLSTM;
  * loss: InfoNCE contrastive with K=5 distractors sampled from other
    timesteps of the same utterance (`loss.py:24-54` — there a Python loop,
    here a vectorized gather) + α·diversity term (`loss.py:55-68`).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from nn_conformer_for_speech_recognition_tpu.config import (
    ModelConfig,
    PretrainConfig,
)
from nn_conformer_for_speech_recognition_tpu.models import layers as nn
from nn_conformer_for_speech_recognition_tpu.models.conformer import (
    ConformerEncoder,
    length_mask,
)
from nn_conformer_for_speech_recognition_tpu.models.subsampling import ConvSubsampling
from nn_conformer_for_speech_recognition_tpu.models.asr import BiLSTM


class PretrainModel(nn.Module):
    """(B, T, n_mels) → (context_vectors, target_vectors, mask_positions)."""

    config: ModelConfig
    pretrain: PretrainConfig

    def __call__(
        self,
        features: jnp.ndarray,
        frame_lengths: jnp.ndarray,
        deterministic: bool = False,
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        cfg = self.config
        pt = self.pretrain
        h, lengths = ConvSubsampling(cfg.subsampling, cfg.encoder.d_model)(
            features, frame_lengths
        )

        # target path: linear quantization (`nn.py:57-70`)
        targets = nn.Dense(pt.target_dim, name="quant_proj")(h)
        if pt.use_gumbel_quantizer and not deterministic:
            g_rng = self.make_rng("gumbel")
            g = -jnp.log(-jnp.log(jax.random.uniform(g_rng, targets.shape) + 1e-10) + 1e-10)
            targets = jax.nn.softmax((targets + g) / pt.gumbel_tau, axis=-1)

        # context path: random masking (`nn.py:44-55`)
        if deterministic:
            mask_pos = jnp.zeros(h.shape[:2], bool)
        else:
            m_rng = self.make_rng("mask")
            mask_pos = jax.random.uniform(m_rng, h.shape[:2]) < pt.mask_probability
        valid = length_mask(lengths, h.shape[1])
        mask_pos = mask_pos & valid
        ctx = jnp.where(mask_pos[..., None], pt.mask_value, h)
        ctx = nn.Dense(cfg.encoder.d_model, name="pre_context")(ctx)
        ctx = ConformerEncoder(cfg.encoder, name="context_net")(
            ctx, lengths, deterministic=deterministic
        )
        ctx = BiLSTM(pt.target_dim // 2, name="decoder")(ctx, lengths)
        return ctx, targets, mask_pos, lengths


def contrastive_loss(
    context: jnp.ndarray,  # (B, T, D)
    targets: jnp.ndarray,  # (B, T, D)
    mask_pos: jnp.ndarray,  # (B, T) bool — masked positions to predict
    lengths: jnp.ndarray,  # (B,)
    rng: jax.Array,
    k_distractors: int = 5,
    temperature: float = 0.1,
    diversity_alpha: float = 0.1,
) -> jnp.ndarray:
    """InfoNCE over masked positions with K within-utterance distractors
    (vectorized form of `loss.py:24-54`) + α·diversity (`loss.py:55-68`)."""
    b, t, d = context.shape

    def _unit(x):
        # rsqrt(sumsq + eps): finite value AND gradient at x == 0, unlike
        # norm-then-divide (d√x at 0 is inf → NaN grads on padded frames)
        return x * jax.lax.rsqrt(jnp.sum(x * x, axis=-1, keepdims=True) + 1e-12)

    def cos(a, bb):
        return jnp.sum(_unit(a) * _unit(bb), axis=-1)

    pos_sim = cos(context, targets) / temperature  # (B, T)

    # K distractor indices per (b, t), drawn from [0, length), shifted to
    # avoid the positive index
    u = jax.random.uniform(rng, (b, t, k_distractors))
    max_others = jnp.maximum(lengths[:, None, None] - 1, 1)
    offs = 1 + jnp.floor(u * max_others).astype(jnp.int32)  # in [1, len-1]
    idx = (jnp.arange(t)[None, :, None] + offs) % jnp.maximum(
        lengths[:, None, None], 1
    )  # (B, T, K), != t whenever length > 1
    dis = jnp.take_along_axis(
        targets[:, None, :, :].repeat(t, axis=1),
        idx[..., None].repeat(d, axis=-1),
        axis=2,
    )  # (B, T, K, D)
    neg_sim = cos(context[:, :, None, :], dis) / temperature  # (B, T, K)

    logits = jnp.concatenate([pos_sim[..., None], neg_sim], axis=-1)
    logdenom = jax.nn.logsumexp(logits, axis=-1)
    nce = -(pos_sim - logdenom)  # (B, T)

    w = mask_pos.astype(nce.dtype)
    loss = jnp.sum(nce * w) / jnp.maximum(jnp.sum(w), 1.0)

    if diversity_alpha > 0:
        # diversity: maximize entropy of the mean target distribution
        valid = (jnp.arange(t)[None, :] < lengths[:, None])[..., None]
        probs = jax.nn.softmax(targets, axis=-1)
        mean_p = jnp.sum(probs * valid, axis=(0, 1)) / jnp.maximum(
            jnp.sum(valid), 1.0
        )
        entropy = -jnp.sum(mean_p * jnp.log(mean_p + 1e-10))
        loss = loss - diversity_alpha * entropy
    return loss
