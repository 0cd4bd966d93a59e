"""Contrastive pretraining loop — counterpart of
`unused_lib/pretraining/runner.py:12-89` (Adam lr=3e-5 over the unlabeled
split, loss curve, save), as a jitted sharded step like the supervised loop.
The pretrained encoder transfers into the ASR model via
``checkpoint.restore_encoder_params`` (the `hp.load_pretraining` path,
`lib/standard/runner.py:61-77`)."""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nn_conformer_for_speech_recognition_tpu.utils.rng import dropout_key

from nn_conformer_for_speech_recognition_tpu.config import (
    FeatureConfig,
    MeshConfig,
    ModelConfig,
    PretrainConfig,
)
from nn_conformer_for_speech_recognition_tpu.data.datasets import BucketedDataset
from nn_conformer_for_speech_recognition_tpu.models.pretrain import (
    PretrainModel,
    contrastive_loss,
)
from nn_conformer_for_speech_recognition_tpu.ops.features import log_mel_spectrogram
from nn_conformer_for_speech_recognition_tpu.parallel import mesh as pmesh
from nn_conformer_for_speech_recognition_tpu.train.state import TrainState


class PretrainTrainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        pretrain_cfg: PretrainConfig,
        feat_cfg: FeatureConfig,
        mesh_cfg: MeshConfig = MeshConfig(),
        mesh=None,
        log_fn=print,
    ):
        self.model = PretrainModel(model_cfg, pretrain_cfg)
        self.cfg = pretrain_cfg
        self.feat_cfg = feat_cfg
        self.mesh_cfg = mesh_cfg
        self.mesh = mesh if mesh is not None else pmesh.make_mesh(mesh_cfg)
        self.tx = optax.adam(pretrain_cfg.learning_rate)
        self.log = log_fn
        self.state: Optional[TrainState] = None
        self.history: Dict[str, List[float]] = {"pretrain_loss": []}

        cfg = pretrain_cfg

        def train_step(state: TrainState, audio, audio_lengths):
            rng, m_rng, g_rng, d_rng = jax.random.split(state.rng, 4)
            d_rng = dropout_key(d_rng)  # the platform's dropout PRNG (utils/rng.py)
            feats, flens = log_mel_spectrogram(audio, feat_cfg, audio_lengths)

            def loss_fn(params):
                (ctx, tgt, mask_pos, lengths), updates = self.model.apply(
                    {"params": params, "batch_stats": state.batch_stats},
                    feats,
                    flens,
                    deterministic=False,
                    rngs={"mask": m_rng, "gumbel": g_rng, "dropout": d_rng},
                    mutable=["batch_stats"],
                )
                loss = contrastive_loss(
                    ctx, tgt, mask_pos, lengths, d_rng,
                    k_distractors=cfg.distractors_k,
                    temperature=cfg.temperature,
                    diversity_alpha=cfg.diversity_alpha,
                )
                return loss, updates["batch_stats"]

            (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
            new_state = state.apply_gradients(grads, new_bs, rng)
            return new_state, loss

        self._train_step = jax.jit(train_step)

    def init_state(self, seed: int = 0):
        t = self.feat_cfg.num_frames(self.feat_cfg.sample_rate)
        feats = jnp.zeros((2, t, self.feat_cfg.n_mels))
        flens = jnp.full((2,), t)
        variables = jax.jit(
            functools.partial(self.model.init, deterministic=False)
        )(
            {
                "params": jax.random.key(seed),
                "mask": jax.random.key(seed + 1),
                "gumbel": jax.random.key(seed + 2),
                "dropout": jax.random.key(seed + 3),
            },
            feats,
            flens,
        )
        params = pmesh.shard_params(self.mesh, variables["params"], self.mesh_cfg)
        batch_stats = jax.device_put(
            variables.get("batch_stats", {}), pmesh.replicated(self.mesh)
        )
        self.state = TrainState.create(params, batch_stats, self.tx, jax.random.key(seed))
        return self.state

    def train(self, dataset: BucketedDataset, epochs: int):
        assert self.state is not None
        for epoch in range(epochs):
            t0 = time.time()
            total, n = 0.0, 0
            for batch in dataset.epoch(seed=epoch):
                audio, alen = pmesh.shard_batch_arrays(
                    self.mesh, self.mesh_cfg,
                    batch.audio, batch.audio_lengths.astype(np.int32),
                )
                self.state, loss = self._train_step(self.state, audio, alen)
                total += float(loss)
                n += 1
            mean = total / max(n, 1)
            self.history["pretrain_loss"].append(mean)
            self.log(f"pretrain epoch {epoch}: loss={mean:.4f} ({time.time()-t0:.1f}s)")
        return self.history

    def save(self, path: str):
        from nn_conformer_for_speech_recognition_tpu.train.checkpoint import save_state

        save_state(path, self.state)
