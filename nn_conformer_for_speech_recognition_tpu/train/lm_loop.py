"""LM training loop: teacher-forced cross-entropy + perplexity.

The reference trains its enc-dec LM inside the same Runner with
``lm=True`` (`lib/standard/runner.py:137-139,162`: CE loss, perplexity =
exp(loss)).  Here it is its own jitted sharded trainer over
`models/lm.TransformerLM` examples from `data/lm_corpus.LMCorpus`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nn_conformer_for_speech_recognition_tpu.utils.rng import dropout_key

from nn_conformer_for_speech_recognition_tpu.config import LMConfig, MeshConfig
from nn_conformer_for_speech_recognition_tpu.models.lm import TransformerLM
from nn_conformer_for_speech_recognition_tpu.parallel import mesh as pmesh
from nn_conformer_for_speech_recognition_tpu.train.metrics import perplexity
from nn_conformer_for_speech_recognition_tpu.train.state import TrainState


class LMTrainer:
    def __init__(
        self,
        cfg: LMConfig,
        src_vocab_size: int,
        tgt_vocab_size: int,
        tgt_pad_id: int,
        learning_rate: float = 2e-4,
        mesh_cfg: MeshConfig = MeshConfig(),
        mesh=None,
        log_fn=print,
    ):
        self.cfg = cfg
        self.model = TransformerLM(
            src_vocab=src_vocab_size,
            tgt_vocab=tgt_vocab_size,
            d=cfg.embed_dim,
            heads=cfg.num_heads,
            ffn=cfg.ffn_dim,
            enc_layers=cfg.num_encoder_layers,
            dec_layers=cfg.num_decoder_layers,
            dropout=cfg.dropout,
        )
        self.pad_id = tgt_pad_id
        self.tx = optax.adamw(learning_rate)
        self.mesh_cfg = mesh_cfg
        self.mesh = mesh if mesh is not None else pmesh.make_mesh(mesh_cfg)
        self.log = log_fn
        self.state: Optional[TrainState] = None
        self.history: Dict[str, List[float]] = {"lm_loss": [], "lm_ppl": []}

        pad = tgt_pad_id

        def train_step(state: TrainState, src, slen, tgt, tlen):
            rng, do_rng = jax.random.split(state.rng)
            do_rng = dropout_key(do_rng)  # the platform's dropout PRNG (utils/rng.py)
            src_mask = jnp.arange(src.shape[1])[None, :] < slen[:, None]
            tgt_mask = jnp.arange(tgt.shape[1])[None, :] < tlen[:, None]
            # teacher forcing: input = <pad>-shifted target, label = target
            dec_in = jnp.pad(tgt[:, :-1], ((0, 0), (1, 0)), constant_values=pad)

            def loss_fn(params):
                logits = self.model.apply(
                    {"params": params}, src, dec_in,
                    src_mask=src_mask, tgt_mask=tgt_mask,
                    deterministic=False, rngs={"dropout": do_rng},
                )
                ce = optax.softmax_cross_entropy_with_integer_labels(logits, tgt)
                w = tgt_mask.astype(ce.dtype)
                return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)

            loss, grads = jax.value_and_grad(loss_fn)(state.params)
            return state.apply_gradients(grads, state.batch_stats, rng), loss

        self._train_step = jax.jit(train_step)

        def score_step(state: TrainState, src, slen, tgt, tlen):
            src_mask = jnp.arange(src.shape[1])[None, :] < slen[:, None]
            tgt_mask = jnp.arange(tgt.shape[1])[None, :] < tlen[:, None]
            dec_in = jnp.pad(tgt[:, :-1], ((0, 0), (1, 0)), constant_values=pad)
            logits = self.model.apply(
                {"params": state.params}, src, dec_in,
                src_mask=src_mask, tgt_mask=tgt_mask, deterministic=True,
            )
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, tgt)
            w = tgt_mask.astype(ce.dtype)
            return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)

        self._score_step = jax.jit(score_step)

    def init_state(self, seed: int = 0):
        src = jnp.zeros((2, 8), jnp.int32)
        tgt = jnp.zeros((2, 4), jnp.int32)
        variables = jax.jit(self.model.init)(
            {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
            src, tgt,
        )
        params = pmesh.shard_params(self.mesh, variables["params"], self.mesh_cfg)
        self.state = TrainState.create(params, {}, self.tx, jax.random.key(seed))
        return self.state

    def _put(self, *arrays):
        return pmesh.shard_batch_arrays(self.mesh, self.mesh_cfg, *arrays)

    def train(self, corpus, epochs: int, batch_size: int = 32):
        assert self.state is not None
        for epoch in range(epochs):
            t0 = time.time()
            total, n = 0.0, 0
            for src, slen, tgt, tlen in corpus.batches(batch_size, seed=epoch):
                args = self._put(src, slen, tgt, tlen)
                self.state, loss = self._train_step(self.state, *args)
                total += float(loss)
                n += 1
            mean = total / max(n, 1)
            self.history["lm_loss"].append(mean)
            self.history["lm_ppl"].append(perplexity(mean))
            self.log(
                f"lm epoch {epoch}: loss={mean:.4f} ppl={perplexity(mean):.2f} "
                f"({time.time()-t0:.1f}s)"
            )
        return self.history

    def evaluate(self, corpus, batch_size: int = 32) -> float:
        assert self.state is not None
        total, n = 0.0, 0
        for src, slen, tgt, tlen in corpus.batches(batch_size, shuffle=False):
            args = self._put(src, slen, tgt, tlen)
            total += float(self._score_step(self.state, *args))
            n += 1
        return total / max(n, 1)

    def save(self, path: str):
        from nn_conformer_for_speech_recognition_tpu.train.checkpoint import save_state

        save_state(path, self.state)
