"""Device-resident dataset cache.

For corpora that fit in device memory (SpeechCommands-scale: 63k 1-s clips
≈ 4 GB f32, or any NST demo subset), uploading the decoded audio ONCE and
gathering batches on-device (``jnp.take``) removes host→device transfer from
the training loop entirely — the pattern of `examples/nst_demo.py`.  The
reference
keeps everything in host RAM and pays a H2D copy per step
(`speechcommands.py:191-196`).

``DeviceResidentDataset`` duck-types `BucketedDataset`'s Trainer-facing
surface (``epoch`` / ``utterances`` / ``vocab`` / ``with_pseudo_labels``),
so ``Trainer`` and ``nst.driver.run_nst`` work unchanged.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Iterator, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from nn_conformer_for_speech_recognition_tpu.data.datasets import (
    Batch,
    BucketedDataset,
    Utterance,
)


def gather_rows(audio, alen, targets, tlen, idx):
    """Gather one batch (rows ``idx``) from device-resident arrays.

    ``idx`` entries of -1 are batch padding: their audio/targets/lengths are
    zeroed so downstream masking (``target_lengths == 0`` row weights in the
    train step) ignores them.  Used both per-dispatch (`epoch`) and inside
    the fused epoch scan (`train.loop.make_epoch_scan_step`).
    """
    take = lambda x: jnp.take(x, jnp.maximum(idx, 0), axis=0)
    valid = (idx >= 0)
    a = take(audio)
    return (
        a * valid[:, None].astype(a.dtype),
        take(alen) * valid,
        jnp.where(valid[:, None], take(targets), 0),
        take(tlen) * valid,
    )


_gather = jax.jit(gather_rows)


class DeviceResidentDataset:
    """All audio + targets resident on device; batches gathered on-device."""

    def __init__(
        self,
        source: BucketedDataset,
        pad_to: Optional[int] = None,
        sharding=None,
    ):
        self.vocab = source.vocab
        self.batch_size = source.batch_size
        self.sample_rate = source.sample_rate
        self.max_target_len = source.max_target_len
        self.utterances: List[Utterance] = list(source.utterances)
        self.bucket_boundaries = source.bucket_boundaries
        pad_to = pad_to or max(source.bucket_boundaries)

        n = len(source.utterances)
        audio = np.zeros((n, pad_to), np.float32)
        alen = np.zeros((n,), np.int32)
        targets = np.full((n, source.max_target_len), self.vocab.pad_id, np.int32)
        tlen = np.zeros((n,), np.int32)
        for i, u in enumerate(source.utterances):
            x = source._audio(i)[:pad_to]
            audio[i, : len(x)] = x
            alen[i] = len(x)
            if u.labeled:
                ids = self.vocab.parse(u.transcript)[: source.max_target_len]
                targets[i, : len(ids)] = ids
                tlen[i] = len(ids)

        put = (lambda x: jax.device_put(x, sharding)) if sharding else jax.device_put
        self._audio_dev = put(audio)
        self._alen_dev = put(alen)
        self._targets_dev = put(targets)
        self._tlen_dev = put(tlen)

    def __len__(self) -> int:
        return len(self.utterances)

    def device_arrays(self):
        """(audio, alen, targets, tlen) device-resident arrays, for the fused
        epoch scan (`train.loop.Trainer.train_device_epochs`)."""
        return self._audio_dev, self._alen_dev, self._targets_dev, self._tlen_dev

    def order_matrix(self, seed: Optional[int] = None, shuffle: bool = True) -> np.ndarray:
        """(num_batches, batch_size) int32 index matrix for one epoch;
        -1 marks batch-padding rows.  Same shuffle as `epoch`."""
        n = len(self.utterances)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        steps = self.num_batches()
        mat = np.full((steps, self.batch_size), -1, np.int32)
        flat = mat.reshape(-1)
        flat[:n] = order
        return mat

    def num_batches(self) -> int:
        return -(-len(self.utterances) // self.batch_size)

    def set_targets(self, index_to_ids: Dict[int, Sequence[int]]) -> None:
        """Update targets for a subset (NST pseudo-labels) — a tiny upload."""
        targets = np.array(self._targets_dev)  # writable copies
        tlen = np.array(self._tlen_dev)
        for i, ids in index_to_ids.items():
            ids = list(ids)[: self.max_target_len]
            targets[i] = self.vocab.pad_id
            targets[i, : len(ids)] = ids
            tlen[i] = len(ids)
        self._targets_dev = jax.device_put(targets)
        self._tlen_dev = jax.device_put(tlen)

    def epoch(self, seed: Optional[int] = None, shuffle: bool = True) -> Iterator[Batch]:
        n = len(self.utterances)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s0 in range(0, n, self.batch_size):
            idx = np.full((self.batch_size,), -1, np.int64)
            take = order[s0 : s0 + self.batch_size]
            idx[: len(take)] = take
            a, l, t, tl = _gather(
                self._audio_dev, self._alen_dev, self._targets_dev, self._tlen_dev,
                jnp.asarray(idx, jnp.int32),
            )
            yield Batch(a, l, t, tl, idx)

    def with_pseudo_labels(self, labels, unk_tol: float = 0.3,
                           max_target_len: Optional[int] = None):
        return BucketedDataset.with_pseudo_labels(
            self, labels, unk_tol, max_target_len
        )
