"""Conformer encoder blocks.

Block layout is the canonical macaron sandwich — ½FFN → MHSA(rel-pos) →
ConvModule → ½FFN → LayerNorm — matching the reference's from-scratch block
(`unused_lib/conformer.py:128-146`) and Gulati et al. 2020, with the
reference's active-path dims as the parity preset (1 block, d=512, 8 heads,
depthwise k=33, dropout .5 per `lib/standard/asrnn.py:29`).

Design choices:
  * Relative-position self-attention is Transformer-XL style (content bias u,
    position bias v, sinusoidal rel-pos table — superseding the additive
    sinusoidal hack at `unused_lib/conformer.py:92-105`), computed as two
    einsums and a pad/reshape rel-shift (`ops/relshift.py`).
  * The conv module's BatchNorm (`unused_lib/conformer.py:35`) becomes a
    *masked* batch norm: statistics are computed over valid frames only, and
    under jit data parallelism the batch reduction is global automatically
    (XLA GSPMD turns the sharded-batch mean into a cross-replica reduction —
    the SURVEY.md §7 "BatchNorm under DP" item).
  * All sequence handling is mask-based: static shapes, no dynamic slicing,
    so every block jit-compiles to a single fused XLA computation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from nn_conformer_for_speech_recognition_tpu.config import ConformerConfig
from nn_conformer_for_speech_recognition_tpu.models import layers as nn
from nn_conformer_for_speech_recognition_tpu.ops.relshift import rel_shift

NEG_INF = -1e30


def length_mask(lengths: jnp.ndarray, t: int) -> jnp.ndarray:
    """(B,) lengths → (B, T) bool validity mask."""
    return jnp.arange(t)[None, :] < lengths[:, None]


def sinusoidal_rel_positions(t: int, d_model: int) -> np.ndarray:
    """Sinusoidal embeddings for relative distances j-i ∈ [-(T-1), T-1].

    Row l encodes distance d = l - (T-1).  cat(sin, cos) of the inverse-freq
    outer product, the same construction as
    `unused_lib/relativepositionalembeddings.py:26-29`.
    """
    dist = np.arange(-(t - 1), t, dtype=np.float32)  # (2T-1,)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, d_model, 2, dtype=np.float32) / d_model))
    ang = dist[:, None] * inv_freq[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (batch, time) with padded frames excluded from stats.

    Running statistics live in the ``batch_stats`` collection.  Under jit+DP
    the masked sums reduce over the *global* batch via GSPMD — the analogue
    of SyncBatchNorm.
    """

    momentum: float = 0.9
    epsilon: float = 1e-5
    dtype: jnp.dtype = jnp.float32

    def __call__(
        self, x: jnp.ndarray, mask: jnp.ndarray, use_running_average: bool = False
    ) -> jnp.ndarray:
        c = x.shape[-1]
        ra_mean = self.variable("batch_stats", "mean", lambda: jnp.zeros((c,)))
        ra_var = self.variable("batch_stats", "var", lambda: jnp.ones((c,)))
        scale = self.param("scale", jax.nn.initializers.ones, (c,))
        bias = self.param("bias", jax.nn.initializers.zeros, (c,))

        if use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            m = mask[..., None].astype(x.dtype)
            denom = jnp.maximum(jnp.sum(m), 1.0)
            mean = jnp.sum(x * m, axis=(0, 1)) / denom
            var = jnp.sum(((x - mean) ** 2) * m, axis=(0, 1)) / denom
            if not self.is_initializing():
                ra_mean.value = self.momentum * ra_mean.value + (1 - self.momentum) * mean
                ra_var.value = self.momentum * ra_var.value + (1 - self.momentum) * var

        y = (x - mean.astype(x.dtype)) * jax.lax.rsqrt(var.astype(x.dtype) + self.epsilon)
        return y * scale.astype(x.dtype) + bias.astype(x.dtype)


class FeedForwardModule(nn.Module):
    """LN → Dense(ffn_dim) → SiLU → dropout → Dense(d_model) → dropout,
    used with ½ residual weight (`unused_lib/conformer.py:58-66,128-146`)."""

    d_model: int
    ffn_dim: int
    dropout: float
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jnp.ndarray, deterministic: bool) -> jnp.ndarray:
        h = nn.LayerNorm(dtype=self.dtype)(x)
        h = nn.Dense(self.ffn_dim, dtype=self.dtype)(h)
        h = jax.nn.silu(h)
        h = nn.Dropout(self.dropout)(h, deterministic=deterministic)
        h = nn.Dense(self.d_model, dtype=self.dtype)(h)
        return nn.Dropout(self.dropout)(h, deterministic=deterministic)


class RelPositionMHSA(nn.Module):
    """Multi-head self-attention with Transformer-XL relative position bias.

    score(i,j) = (q_i + u)·k_j + (q_i + v)·r_{j-i}, softmax over valid keys.
    """

    d_model: int
    num_heads: int
    dropout: float
    use_relative: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(
        self, x: jnp.ndarray, mask: jnp.ndarray, deterministic: bool
    ) -> jnp.ndarray:
        b, t, _ = x.shape
        h, dh = self.num_heads, self.d_model // self.num_heads
        x = nn.LayerNorm(dtype=self.dtype)(x)

        qkv = nn.Dense(3 * self.d_model, use_bias=False, dtype=self.dtype, name="qkv")(x)
        q, k, v = jnp.split(qkv, 3, axis=-1)
        q = q.reshape(b, t, h, dh)
        k = k.reshape(b, t, h, dh)
        v = v.reshape(b, t, h, dh)

        scale = 1.0 / np.sqrt(dh)

        if self.use_relative:
            u_bias = self.param("u_bias", jax.nn.initializers.zeros, (h, dh))
            v_bias = self.param("v_bias", jax.nn.initializers.zeros, (h, dh))
            rel = jnp.asarray(sinusoidal_rel_positions(t, self.d_model))
            p = nn.Dense(self.d_model, use_bias=False, dtype=self.dtype, name="pos_proj")(rel)
            p = p.reshape(2 * t - 1, h, dh)

            from nn_conformer_for_speech_recognition_tpu.parallel.sequence import (
                active_sequence_mesh,
                seq_parallel_applicable,
                ulysses_relpos_attention,
            )

            seq = active_sequence_mesh()
            if seq is not None and seq_parallel_applicable(
                seq[0], seq[1], t, h
            ):
                # Ulysses sequence parallelism (MeshConfig.seq_parallel):
                # time axis sharded over the mesh, heads + rel-pos table
                # sliced per shard inside — see parallel/sequence.py
                out = ulysses_relpos_attention(
                    q, k, v, p,
                    u_bias.astype(self.dtype), v_bias.astype(self.dtype),
                    mask, scale, mesh=seq[0], axis=seq[1],
                )
            else:
                ac = jnp.einsum(
                    "bihd,bjhd->bhij", q + u_bias.astype(self.dtype), k,
                    preferred_element_type=jnp.float32,
                )
                bd_full = jnp.einsum(
                    "bihd,lhd->bhil", q + v_bias.astype(self.dtype), p,
                    preferred_element_type=jnp.float32,
                )
                # relative index l = (j - i) + (T-1) → absolute (i, j) via the
                # pad/reshape rel-shift, not a gather
                bd = rel_shift(bd_full)
                scores = (ac + bd) * scale
                scores = jnp.where(mask[:, None, None, :], scores, NEG_INF)
                attn = jax.nn.softmax(scores, axis=-1).astype(self.dtype)
                attn = nn.Dropout(self.dropout)(attn, deterministic=deterministic)
                out = jnp.einsum("bhij,bjhd->bihd", attn, v)
        else:
            scores = jnp.einsum(
                "bihd,bjhd->bhij", q, k, preferred_element_type=jnp.float32
            ) * scale
            scores = jnp.where(mask[:, None, None, :], scores, NEG_INF)
            attn = jax.nn.softmax(scores, axis=-1).astype(self.dtype)
            attn = nn.Dropout(self.dropout)(attn, deterministic=deterministic)
            out = jnp.einsum("bhij,bjhd->bihd", attn, v)

        out = out.reshape(b, t, self.d_model)
        out = nn.Dense(self.d_model, dtype=self.dtype, name="out_proj")(out)
        return nn.Dropout(self.dropout)(out, deterministic=deterministic)


class ConvModule(nn.Module):
    """LN → pointwise conv (2× expansion) → GLU → depthwise conv (k=33) →
    masked norm → SiLU → pointwise conv → dropout
    (`unused_lib/conformer.py:76-126`)."""

    d_model: int
    kernel_size: int
    expansion: int
    dropout: float
    norm: str = "batchnorm"
    dtype: jnp.dtype = jnp.float32

    def __call__(
        self, x: jnp.ndarray, mask: jnp.ndarray, deterministic: bool
    ) -> jnp.ndarray:
        h = nn.LayerNorm(dtype=self.dtype)(x)
        h = nn.Dense(2 * self.expansion * self.d_model, dtype=self.dtype)(h)
        a, g = jnp.split(h, 2, axis=-1)
        h = a * jax.nn.sigmoid(g)  # GLU
        # zero padded frames so the depthwise window never reads garbage
        h = h * mask[..., None].astype(h.dtype)

        # no bias when BatchNorm follows: BN subtracts the per-channel
        # mean, so the bias is mathematically inert — its gradient is
        # exactly 0, and under Adam a numerically-noisy "0" gradient
        # random-walks the parameter at ±lr per step.
        h = nn.Conv(
            features=self.expansion * self.d_model,
            kernel_size=(self.kernel_size,),
            padding="SAME",
            feature_group_count=self.expansion * self.d_model,
            use_bias=(self.norm != "batchnorm"),
            dtype=self.dtype,
            name="depthwise",
        )(h)

        if self.norm == "batchnorm":
            h = MaskedBatchNorm(dtype=self.dtype)(
                h, mask, use_running_average=deterministic
            )
        elif self.norm == "groupnorm":
            h = nn.GroupNorm(num_groups=32, dtype=self.dtype)(h)
        else:
            h = nn.LayerNorm(dtype=self.dtype)(h)
        h = jax.nn.silu(h)
        h = nn.Dense(self.d_model, dtype=self.dtype)(h)
        return nn.Dropout(self.dropout)(h, deterministic=deterministic)


class ConformerBlock(nn.Module):
    config: ConformerConfig
    dtype: jnp.dtype = jnp.float32

    def __call__(
        self, x: jnp.ndarray, mask: jnp.ndarray, deterministic: bool
    ) -> jnp.ndarray:
        cfg = self.config
        x = x + 0.5 * FeedForwardModule(
            cfg.d_model, cfg.ffn_dim, cfg.dropout, dtype=self.dtype, name="ffn1"
        )(x, deterministic)
        x = x + RelPositionMHSA(
            cfg.d_model,
            cfg.num_heads,
            cfg.attention_dropout,
            use_relative=cfg.use_relative_attention,
            dtype=self.dtype,
            name="mhsa",
        )(x, mask, deterministic)
        x = x + ConvModule(
            cfg.d_model,
            cfg.conv_kernel_size,
            cfg.conv_expansion,
            cfg.dropout,
            norm=cfg.conv_norm,
            dtype=self.dtype,
            name="conv",
        )(x, mask, deterministic)
        x = x + 0.5 * FeedForwardModule(
            cfg.d_model, cfg.ffn_dim, cfg.dropout, dtype=self.dtype, name="ffn2"
        )(x, deterministic)
        x = nn.LayerNorm(dtype=self.dtype)(x)
        return x * mask[..., None].astype(x.dtype)


class ConformerEncoder(nn.Module):
    """Stack of Conformer blocks; ``remat`` recomputes each block in the
    backward pass instead of storing its activations."""

    config: ConformerConfig
    remat: bool = False
    dtype: jnp.dtype = jnp.float32

    def __call__(
        self, x: jnp.ndarray, lengths: jnp.ndarray, deterministic: bool = True
    ) -> jnp.ndarray:
        mask = length_mask(lengths, x.shape[1])
        block_cls = ConformerBlock
        if self.remat:
            # `deterministic` is a python bool: static for jax.checkpoint
            block_cls = nn.remat(ConformerBlock, static_argnums=(3,))
        for i in range(self.config.num_blocks):
            x = block_cls(self.config, dtype=self.dtype, name=f"block_{i}")(
                x, mask, deterministic
            )
        return x
