"""Immutable configuration for the Conformer ASR framework.

The reference (`/root/reference/lib/hparams.py:14-145`) uses a single mutable
``HParams`` god-object whose fields are mutated post-hoc by the datasets
(``set_max_len``/``set_vocab_len``/... at `lib/hparams.py:127-145`).  Here every
config is a frozen dataclass: derived shapes are *computed* (e.g.
``subsampled_length``), never mutated in, and dataset-dependent quantities
(vocab size, feature dim) are passed explicitly where needed.  This keeps
configs hashable so they can be closed over by ``jax.jit`` without retracing
hazards.

Model size presets follow BASELINE.json's configs: Conformer-S/M/L.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------


@_frozen
class FeatureConfig:
    """Log-mel spectrogram extraction.

    Defaults mirror the reference pipeline (librosa melspectrogram with
    ``n_mels=40``, ``hop_length=512`` — `lib/hparams.py:41-42`,
    `lib/standard/speechcommands.py:113`), with the reference's per-utterance
    min-max normalisation (`speechcommands.py:117-119`) available as
    ``normalize='minmax'``.
    """

    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 512
    win_length: Optional[int] = None  # defaults to n_fft
    n_mels: int = 40
    fmin: float = 0.0
    fmax: Optional[float] = None  # defaults to sample_rate / 2
    log_floor: float = 1e-10
    # 'minmax' = reference per-utterance min-max (speechcommands.py:117-119);
    # 'meanvar' = per-utterance CMVN; 'none'
    normalize: str = "minmax"
    # htk-style mel scale matches librosa(htk=True)=False default; we use the
    # Slaney scale like librosa's default.
    htk: bool = False

    @property
    def win_length_(self) -> int:
        return self.win_length or self.n_fft

    @property
    def fmax_(self) -> float:
        return self.fmax if self.fmax is not None else self.sample_rate / 2.0

    def num_frames(self, num_samples: int) -> int:
        """Number of STFT frames for a centered STFT (librosa semantics)."""
        return num_samples // self.hop_length + 1


# ---------------------------------------------------------------------------
# SpecAugment
# ---------------------------------------------------------------------------


@_frozen
class SpecAugmentConfig:
    """SpecAugment policy.

    Parameter names and defaults follow the reference
    (`lib/hparams.py:85-95`): W=1 time-warp, F=5 frequency mask applied
    twice, T=5 time mask with multiplicity Mt=2, adaptive multiplicity
    (``Mt = min(Mt, floor(pm * tau))``) and adaptive size
    (``T = floor(ps * tau)``) per `lib/standard/asrnn.py:146-192`.
    """

    time_warp_w: int = 1
    time_warp_n: int = 1
    freq_mask_f: int = 5
    freq_mask_n: int = 2
    time_mask_t: int = 5
    time_mask_n: int = 2
    pm: float = 0.05
    ps: float = 0.05
    adaptive_multiplicity: bool = False
    adaptive_size: bool = False
    mask_value: float = 0.0


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@_frozen
class SubsamplingConfig:
    """Convolutional subsampling frontend.

    The reference flattens the conv output and pushes it through a
    fixed-``max_len`` Linear (`lib/standard/asrnn.py:28,206-209`), which
    breaks length generalisation; we deviate intentionally and use
    time-preserving stride-2 convs (documented in SURVEY.md §7).
    Channel counts echo `lib/hparams.py:46-51` (512 → 128).
    """

    channels: Tuple[int, ...] = (512, 128)
    kernel_sizes: Tuple[int, ...] = (7, 3)
    time_strides: Tuple[int, ...] = (2, 2)
    freq_strides: Tuple[int, ...] = (2, 2)

    @property
    def time_reduction(self) -> int:
        r = 1
        for s in self.time_strides:
            r *= s
        return r

    def subsampled_length(self, t: int) -> int:
        for s in self.time_strides:
            t = -(-t // s)  # ceil div: SAME padding conv with stride s
        return t


@_frozen
class ConformerConfig:
    """Conformer encoder.

    Defaults for the reference parity config: 1 block, d_model=512, 8 heads,
    ff dim 512, depthwise kernel 33, dropout 0.5
    (`lib/standard/asrnn.py:29`, `lib/hparams.py:43-63`).  The block layout
    is the canonical macaron sandwich: ½FFN → MHSA(rel-pos) → Conv → ½FFN →
    LN, as in `unused_lib/conformer.py:128-146` and Gulati et al. 2020.
    """

    num_blocks: int = 1
    d_model: int = 512
    num_heads: int = 8
    ffn_dim: int = 512
    ffn_expansion_in_block: bool = True  # if True, ffn_dim is the hidden size
    conv_kernel_size: int = 33
    conv_expansion: int = 2  # pointwise conv expands to conv_expansion*d_model
    dropout: float = 0.5
    attention_dropout: float = 0.0
    use_relative_attention: bool = True
    # 'batchnorm' (masked, cross-replica-syncable) or 'groupnorm' or 'layernorm'
    conv_norm: str = "batchnorm"


@_frozen
class DecoderConfig:
    """CTC head: projection + BiLSTM + linear, per `lib/standard/asrnn.py`.

    projection Linear d_model→256 + SiLU + norm (`asrnn.py:73-89`),
    BiLSTM 256→2×512 (`lib/hparams.py:78-81`), final Linear → vocab.
    """

    projection_dim: int = 256
    lstm_hidden: int = 512
    lstm_layers: int = 1
    bidirectional: bool = True
    dropout: float = 0.5


@_frozen
class ModelConfig:
    subsampling: SubsamplingConfig = SubsamplingConfig()
    encoder: ConformerConfig = ConformerConfig()
    decoder: DecoderConfig = DecoderConfig()
    n_mels: int = 40
    # computation dtype ('auto' | 'bfloat16' | 'float32'): params stay f32;
    # this is the matmul/activation dtype.  'auto' resolves per platform
    # (backend.routes): bfloat16 on the GPU, float32 on the CPU.
    compute_dtype: str = "auto"
    # rematerialise each Conformer block in backward (jax.checkpoint): trades
    # ~1 extra forward of FLOPs for O(num_blocks) less activation memory —
    # for long-form audio or large batches.  Leave off when activations fit:
    # the recompute is pure overhead.
    remat: bool = False

    def subsampled_length(self, t: int) -> int:
        return self.subsampling.subsampled_length(t)

    def resolved_compute_dtype(self) -> str:
        """'bfloat16' or 'float32'; 'auto' asks `backend.routes`."""
        if self.compute_dtype == "auto":
            from nn_conformer_for_speech_recognition_tpu.backend import routes

            return routes().compute_dtype
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"compute_dtype must be 'auto', 'bfloat16' or 'float32', "
                f"got {self.compute_dtype!r}"
            )
        return self.compute_dtype


def conformer_s(**overrides) -> ModelConfig:
    """~10M param Conformer-S (BASELINE.json configs[0-1])."""
    enc = ConformerConfig(
        num_blocks=4, d_model=256, num_heads=4, ffn_dim=1024,
        conv_kernel_size=33, dropout=0.1,
    )
    dec = DecoderConfig(projection_dim=256, lstm_hidden=320, dropout=0.1)
    return ModelConfig(encoder=enc, decoder=dec, **overrides)


def conformer_m(**overrides) -> ModelConfig:
    """Conformer-M, 16 blocks (BASELINE.json configs[2-3])."""
    enc = ConformerConfig(
        num_blocks=16, d_model=256, num_heads=4, ffn_dim=1024,
        conv_kernel_size=33, dropout=0.1,
    )
    dec = DecoderConfig(projection_dim=256, lstm_hidden=320, dropout=0.1)
    return ModelConfig(encoder=enc, decoder=dec, **overrides)


def conformer_l(**overrides) -> ModelConfig:
    """~100M param Conformer-L (BASELINE.json configs[4])."""
    enc = ConformerConfig(
        num_blocks=17, d_model=512, num_heads=8, ffn_dim=2048,
        conv_kernel_size=33, dropout=0.1,
    )
    dec = DecoderConfig(projection_dim=512, lstm_hidden=640, dropout=0.1)
    return ModelConfig(encoder=enc, decoder=dec, **overrides)


def reference_parity(**overrides) -> ModelConfig:
    """The reference's exact active config: 1 block, d=512, 8 heads, k=33,
    dropout .5 (`lib/standard/asrnn.py:29`)."""
    return ModelConfig(**overrides)


MODEL_PRESETS = {
    "reference": reference_parity,
    "conformer_s": conformer_s,
    "conformer_m": conformer_m,
    "conformer_l": conformer_l,
}


# ---------------------------------------------------------------------------
# Parallelism
# ---------------------------------------------------------------------------


@_frozen
class MeshConfig:
    """Logical device mesh.

    ``data`` shards the batch (DP); ``model`` shards attention heads / FFN
    hidden dims (TP) for Conformer-L when one device's memory is short.
    The reference has no distributed support at all (SURVEY.md §2.3).
    """

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1  # 1 = pure DP
    # Ulysses sequence parallelism: shard the attention's TIME axis over the
    # data axis (all-to-all to head shards inside, `parallel/sequence.py`).
    # For very long audio with small batches — enable when T·heads per chip
    # is the memory/compute bottleneck rather than batch; requires
    # num_heads % axis_size == 0 (falls back to the dense path otherwise).
    seq_parallel: bool = False


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@_frozen
class OptimizerConfig:
    """Adafactor matching `lib/standard/runner.py:36` semantics:
    fixed lr, beta1(momentum)=0.9, scale_parameter=False, relative_step=False.
    """

    name: str = "adafactor"
    learning_rate: float = 2e-5
    momentum: float = 0.9
    weight_decay: float = 0.0
    clip_threshold: float = 1.0
    warmup_steps: int = 0  # 0 = constant lr (reference semantics)
    schedule: str = "constant"  # or 'transformer' (inverse-sqrt w/ warmup)


@_frozen
class TrainConfig:
    batch_size: int = 32  # global batch (lib/hparams.py:36)
    epochs: int = 15  # lib/hparams.py:38
    optimizer: OptimizerConfig = OptimizerConfig()
    specaugment: SpecAugmentConfig = SpecAugmentConfig()
    use_specaugment: bool = True
    seed: int = 0
    log_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    # also checkpoint every N steps WITH the data-iterator cursor (epoch,
    # step) so a mid-epoch kill resumes at the exact step, not the epoch
    # boundary (SURVEY.md §5 full train-state; 0 = per-epoch only)
    checkpoint_every_steps: int = 0
    donate_state: bool = True
    # length bucketing replaces the reference's global max_len padding
    # (`speechcommands.py:188-190`); bucket boundaries in frames.
    bucket_boundaries: Tuple[int, ...] = ()
    max_frames: Optional[int] = None
    # waveform gaussian-noise augmentation, the reference's 'balanced' data
    # path (`speechcommands.py:227-252`)
    add_noise: bool = False
    noise_std: float = 0.01
    # log per-epoch WER of the training forward's greedy decodes (the
    # reference logs this per batch, `runner.py:149-160`); costs an in-graph
    # argmax+collapse per step plus an ids pull at epoch end.
    train_wer: bool = False
    # CTC prefix beam search knobs (Trainer.evaluate(decode='beam') and the
    # CLI's `eval --decode beam --beam N --prune K`; BASELINE.json configs[2])
    beam: int = 8
    prune: int = 16
    max_label_len: int = 64


@_frozen
class NSTConfig:
    """Noisy Student Training loop, per `lib/finetuning/finetune.py:17-35`:
    ft_lr=3e-6, 3 generations, 1 train epoch per generation, initial
    supervised finetune (`lib/hparams.py:105-107`)."""

    ft_lr: float = 3e-6
    generations: int = 3
    train_epochs_per_generation: int = 1
    initial_supervised_finetune: bool = True
    # pseudo-label filtering, semantics of `librispeech.py:108-123`
    unk_tolerance: float = 0.3  # lib/hparams.py:37 unk_tol
    max_target_len: Optional[int] = None
    add_noise: bool = False  # gaussian-noise augmentation (speechcommands.py:227-252)
    noise_std: float = 0.01


@_frozen
class PretrainConfig:
    """wav2vec-2.0-style contrastive pretraining
    (`unused_lib/pretraining/{nn,loss}.py`)."""

    learning_rate: float = 3e-5  # lib/hparams.py:34
    epochs: int = 100  # lib/hparams.py:39
    mask_probability: float = 0.065  # lib/hparams.py:52
    mask_value: float = 0.0
    target_dim: int = 320  # target_context_vectors_size lib/hparams.py:54
    distractors_k: int = 5  # lib/hparams.py:87 distractors_K
    temperature: float = 0.1  # temperature_loss lib/hparams.py:86
    diversity_alpha: float = 0.1  # alpha_loss lib/hparams.py:85
    use_gumbel_quantizer: bool = False  # simplified_pretraining=True default
    gumbel_tau: float = 2.0  # temperature_tau lib/hparams.py:88


@_frozen
class LMConfig:
    """Transformer encoder-decoder LM over pronunciation→word streams
    (`unused_lib/finetuning/languagemodel.py`)."""

    vocab_size: int = 256  # lm_ntokens lib/hparams.py:94
    num_encoder_layers: int = 4  # lm_in_N lib/hparams.py:108
    num_decoder_layers: int = 4  # lm_out_N
    embed_dim: int = 320  # input_embedding_size lib/hparams.py:110
    num_heads: int = 8
    ffn_dim: int = 512  # lm_innner_input_nodes lib/hparams.py:115-116
    max_len: int = 20  # lm_max_len lib/hparams.py:118
    dropout: float = 0.1
    epochs: int = 3
    ngram: int = 2  # shallow-fusion ngram context (lib/hparams.py:30)


# ---------------------------------------------------------------------------
# Vocab
# ---------------------------------------------------------------------------


@_frozen
class VocabConfig:
    """Tokenizer selection: word-level vocab (myVocab semantics,
    `lib/standard/myvocab.py`) or word-piece model with CTC-collapse decoding
    (`unused_lib/standard/wordpiecemodel.py`)."""

    kind: str = "word"  # 'word' | 'wordpiece'
    ntokens: Optional[int] = 1024  # truncation cap (lib/hparams.py:36)


@_frozen
class ExperimentConfig:
    """Top-level bundle, the analogue of the reference HParams."""

    features: FeatureConfig = FeatureConfig()
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    nst: NSTConfig = NSTConfig()
    mesh: MeshConfig = MeshConfig()
    vocab: VocabConfig = VocabConfig()

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
