"""Transformer encoder-decoder language model + ASR fusion.

Capability surface of `unused_lib/finetuning/languagemodel.py:6-111`: an
enc-dec transformer over pronunciation→word streams — embeddings with
sinusoidal positional encodings (`:102-106`), N=4 encoder self-attn+FFN
layers (`:57-73`), N=4 decoder blocks of causal self-attention + cross
attention + FFN (`:74-92`, causal mask builder `:41-56`), final projection
(`:108-111`).

Two fusion modes mirror the reference:
  * shallow fusion — ``logits += lm_logits(prev ngram)`` during decoding
    (`lib/standard/asrnn.py:257-258``, ``hp.ngram=2``);
  * weight fusion — additive merge of LM attention projections into the ASR
    Conformer MHSA weights (`lib/standard/runner.py:78-101` ``fuse_models``:
    input-LM layers → first conformer blocks, output-LM layers → mirrored
    last blocks), implemented shape-gated over the param pytrees.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nn_conformer_for_speech_recognition_tpu.models import layers as nn


def sinusoidal_positions(t: int, d: int) -> np.ndarray:
    pos = np.arange(t, dtype=np.float32)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = pos[:, None] * inv_freq[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


class TransformerLayer(nn.Module):
    d: int
    heads: int
    ffn: int
    dropout: float
    causal_self: bool = False
    cross: bool = False

    def __call__(self, x, enc_out=None, mask=None, enc_mask=None, deterministic=True):
        t = x.shape[1]
        attn_mask = None
        if mask is not None:
            attn_mask = mask[:, None, None, :]
        if self.causal_self:
            causal = jnp.tril(jnp.ones((t, t), bool))[None, None]
            attn_mask = causal if attn_mask is None else (attn_mask & causal)
        h = nn.MultiHeadAttention(
            num_heads=self.heads, dropout_rate=self.dropout, name="self_attn"
        )(x, x, mask=attn_mask, deterministic=deterministic)
        x = nn.LayerNorm()(x + h)
        if self.cross:
            cmask = None if enc_mask is None else enc_mask[:, None, None, :]
            h = nn.MultiHeadAttention(
                num_heads=self.heads, dropout_rate=self.dropout, name="cross_attn"
            )(x, enc_out, mask=cmask, deterministic=deterministic)
            x = nn.LayerNorm()(x + h)
        h = nn.Dense(self.ffn)(x)
        h = jax.nn.relu(h)
        h = nn.Dropout(self.dropout)(h, deterministic=deterministic)
        h = nn.Dense(self.d)(h)
        return nn.LayerNorm()(x + h)


class TransformerLM(nn.Module):
    """Pronunciation→word enc-dec LM (vocab ids in, next-word logits out)."""

    src_vocab: int
    tgt_vocab: int
    d: int = 320
    heads: int = 8
    ffn: int = 512
    enc_layers: int = 4
    dec_layers: int = 4
    dropout: float = 0.1

    def __call__(
        self,
        src_ids: jnp.ndarray,  # (B, S) pronunciation stream
        tgt_ids: jnp.ndarray,  # (B, T) word stream (teacher-forced)
        src_mask: Optional[jnp.ndarray] = None,
        tgt_mask: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
    ) -> jnp.ndarray:
        s, t = src_ids.shape[1], tgt_ids.shape[1]
        enc = nn.Embed(self.src_vocab, self.d, name="src_embed")(src_ids)
        enc = enc + jnp.asarray(sinusoidal_positions(s, self.d))
        for i in range(self.enc_layers):
            enc = TransformerLayer(
                self.d, self.heads, self.ffn, self.dropout, name=f"enc_{i}"
            )(enc, mask=src_mask, deterministic=deterministic)

        dec = nn.Embed(self.tgt_vocab, self.d, name="tgt_embed")(tgt_ids)
        dec = dec + jnp.asarray(sinusoidal_positions(t, self.d))
        for i in range(self.dec_layers):
            dec = TransformerLayer(
                self.d, self.heads, self.ffn, self.dropout,
                causal_self=True, cross=True, name=f"dec_{i}",
            )(dec, enc_out=enc, mask=tgt_mask, enc_mask=src_mask,
              deterministic=deterministic)
        return nn.Dense(self.tgt_vocab, name="out_proj")(dec)


class CausalWordLM(nn.Module):
    """Decoder-only word LM used for shallow fusion over greedy ASR decodes:
    given the previous ``ngram`` tokens, produce next-token logits — the
    ``lm(ngram, argmax(x))`` hook of `asrnn.py:257-258`."""

    vocab: int
    d: int = 256
    heads: int = 4
    ffn: int = 512
    layers: int = 2
    dropout: float = 0.1

    def __call__(self, ids: jnp.ndarray, deterministic: bool = True) -> jnp.ndarray:
        t = ids.shape[1]
        x = nn.Embed(self.vocab, self.d)(ids)
        x = x + jnp.asarray(sinusoidal_positions(t, self.d))
        for i in range(self.layers):
            x = TransformerLayer(
                self.d, self.heads, self.ffn, self.dropout,
                causal_self=True, name=f"layer_{i}",
            )(x, deterministic=deterministic)
        return nn.Dense(self.vocab, name="out_proj")(x)


def shallow_fusion(
    asr_log_probs: jnp.ndarray,
    lm_apply,
    lm_weight: float = 0.3,
    ngram: int = 2,
) -> jnp.ndarray:
    """Add LM next-token log-probs for the greedy prefix to ASR frame
    log-probs — the reference's shallow fusion (`asrnn.py:257-258`),
    formulated on-device: prefix = argmax over previous frames (ngram
    context window)."""
    ids = jnp.argmax(asr_log_probs, axis=-1)  # (B, T)
    # context for frame t = ids[t-ngram : t]; shift right by one
    ctx = jnp.pad(ids[:, :-1], ((0, 0), (1, 0)))
    lm_logits = lm_apply(ctx)  # (B, T, V)
    return asr_log_probs + lm_weight * jax.nn.log_softmax(lm_logits, axis=-1)


def _lm_attn_as_qkv_out(attn: Dict):
    """An LM attention module's params → (qkv_kernel (d, 3d), out_kernel
    (d, d)) in the ASR MHSA layout, or None if the module is malformed.

    `layers.MultiHeadAttention` stores query/key/value as (d, H, dh) and
    out as (H, dh, d); the ASR's fused qkv Dense is (d, 3d) with
    [q | k | v] column blocks (`models/conformer.py` RelPositionMHSA), so the
    per-projection merge is exact — the analogue of adding torch's
    ``in_proj_weight`` (3d, d) and ``out_proj.weight``.
    """
    try:
        d = attn["query"]["kernel"].shape[0]
        q, k, v = (
            jnp.reshape(attn[n]["kernel"], (d, -1)) for n in ("query", "key", "value")
        )
        out = jnp.reshape(attn["out"]["kernel"], (-1, d))
    except (KeyError, TypeError):
        return None
    return jnp.concatenate([q, k, v], axis=1), out


def fuse_lm_weights_into_asr(
    asr_params: Dict, lm_params: Dict, scale: float = 1.0
) -> Dict:
    """Structured LM→ASR weight fusion, the reference's ``fuse_models``
    mapping (`lib/standard/runner.py:78-101`):

      * LM **encoder** ("input") layer i's attention projections are added
        into conformer block i's MHSA, projection-by-projection (packed
        q/k/v kernel ↔ qkv Dense, output projection ↔ out_proj);
      * LM **decoder** ("output") layer i's *cross*-attention (the reference
        excludes the masked self-attention, ``'mask' not in x``) is added
        into the MIRRORED block ``n_blocks - i - 1``.

    Kernels merge only when dimensions match (the reference implicitly
    requires lm d_model == asr d_model); the ASR's qkv Dense is biasless so
    the reference's in_proj_bias term has no target — documented deviation.
    Fusing an all-zero LM is exactly a no-op (tested).
    """
    asr_params = jax.tree.map(lambda x: x, asr_params)  # copy

    def lm_layer(prefix: str, i: int) -> Optional[Dict]:
        node = lm_params
        for k in ("params",):
            if k in node and f"{prefix}{i}" not in node:
                node = node[k]
        return node.get(f"{prefix}{i}")

    enc = asr_params.get("encoder", asr_params)
    block_names = sorted(
        [k for k in enc if k.startswith("block_")], key=lambda s: int(s.split("_")[1])
    )
    n_blocks = len(block_names)
    if n_blocks == 0:
        return asr_params

    def add_into(block_name: str, qkv_add, out_add):
        mhsa = enc.get(block_name, {}).get("mhsa")
        if not isinstance(mhsa, dict):
            return
        qkv = mhsa.get("qkv", {}).get("kernel")
        if qkv is not None and qkv.shape == qkv_add.shape:
            mhsa["qkv"]["kernel"] = qkv + scale * qkv_add.astype(qkv.dtype)
        out = mhsa.get("out_proj", {}).get("kernel")
        if out is not None and out.shape == out_add.shape:
            mhsa["out_proj"]["kernel"] = out + scale * out_add.astype(out.dtype)

    # encoder ("input") LM layers → first blocks
    i = 0
    while i < n_blocks:
        layer = lm_layer("enc_", i)
        if layer is None:
            break
        pair = _lm_attn_as_qkv_out(layer.get("self_attn", {}))
        if pair is not None:
            add_into(block_names[i], *pair)
        i += 1

    # decoder ("output") LM layers → mirrored last blocks, cross-attention
    # only (reference: 'output' ... 'mask' not in x)
    i = 0
    while i < n_blocks:
        layer = lm_layer("dec_", i)
        if layer is None:
            break
        pair = _lm_attn_as_qkv_out(layer.get("cross_attn", {}))
        if pair is not None:
            add_into(block_names[n_blocks - i - 1], *pair)
        i += 1
    return asr_params


def make_pron_lm_apply(lm: TransformerLM, lm_variables, pron_table: np.ndarray):
    """Adapter wiring the trained pronunciation→word `TransformerLM` into
    the ASR shallow-fusion hook (`Trainer(lm_apply=...)`).

    ``pron_table``: (word_vocab, P) int32 — each word id's pronunciation
    token ids, pad-right with 0 (built from the lexicon by
    `data/lm_corpus.py`).  The hook receives the greedy context word ids
    (B, T); the pronunciation stream is the table rows flattened per frame
    window, the word stream is the context itself — the reference's
    ``lm(ngram, predict(x))`` with the enc-dec LM
    (`lib/standard/asrnn.py:257-258` + `languagemodel.py:102-111`).

    The table lookup is a one-hot matmul, not a gather.
    """
    table = jnp.asarray(pron_table, jnp.float32)  # (V, P)
    vocab_size = table.shape[0]

    def apply(ctx_ids: jnp.ndarray) -> jnp.ndarray:  # (B, T) → (B, T, V)
        onehot = jax.nn.one_hot(ctx_ids, vocab_size, dtype=jnp.float32)
        pron = jnp.einsum("btv,vp->btp", onehot, table)  # (B, T, P)
        src = jnp.round(pron.reshape(ctx_ids.shape[0], -1)).astype(jnp.int32)
        return lm.apply(lm_variables, src, ctx_ids, deterministic=True)

    return apply
