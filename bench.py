"""Benchmark: Conformer-M training throughput on one NVIDIA GPU.

Config: Conformer-M (16 blocks, d=256), 30-second utterances, B=16, V=1024
(word-piece-sized vocabulary), 100-token targets, bf16 compute.  The step is
the Trainer's: on-device log-mel featurization + SpecAugment, then fwd/bwd +
CTC + Adafactor update.

Timing: one process; each step is dispatched by the host and the window
ends with ``block_until_ready``; the first (compiling) steps are reported
as set-up, not in the window.  Requires a GPU and fails without one.

Reported fields (one JSON line on stdout):
  value/unit     audio-seconds of speech trained per wall-clock second
  ms_per_step    median of ``WINDOWS`` windows of ``STEPS`` steps
  mfu            analytic model FLOPs/step (`utils/flops.py`) ÷ step time ÷
                 the card's dense bf16 peak, looked up by device_kind
  card           name and power limit as nvidia-smi reports them
"""

import json
import subprocess
import sys
import time

import numpy as np

BATCH = 16
SECONDS = 30.0
VOCAB = 1024
TARGET_LEN = 100
STEPS = 20
WINDOWS = 5


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs an NVIDIA GPU, JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[bench] card: {card}", file=sys.stderr)

    from nn_conformer_for_speech_recognition_tpu import config as C
    from nn_conformer_for_speech_recognition_tpu.data.vocab import WordVocab
    from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu.train.loop import Trainer
    from nn_conformer_for_speech_recognition_tpu.utils.flops import (
        peak_flops,
        train_step_flops,
    )

    feat_cfg = C.FeatureConfig()
    mcfg = C.conformer_m(compute_dtype="bfloat16")
    vocab = WordVocab(["<blank>", "<pad>", "<unk>"] + [f"w{i}" for i in range(VOCAB - 3)])
    trainer = Trainer(ConformerCTC(mcfg, vocab_size=len(vocab)), vocab, feat_cfg,
                      C.TrainConfig(batch_size=BATCH), log_fn=lambda s: None)
    state = trainer.init_state(seed=0)

    rng = np.random.default_rng(0)
    n = int(SECONDS * feat_cfg.sample_rate)
    batch = (
        rng.standard_normal((BATCH, n)).astype(np.float32) * 0.1,
        np.full((BATCH,), n, np.int32),
        rng.integers(3, len(vocab), size=(BATCH, TARGET_LEN)).astype(np.int32),
        np.full((BATCH,), TARGET_LEN, np.int32),
    )
    batch = jax.device_put(batch, trainer._batch_sharding)

    t0 = time.perf_counter()
    for _ in range(2):
        state, m = trainer._train_step(state, *batch)
    jax.block_until_ready(m["loss"])
    setup_s = time.perf_counter() - t0

    windows = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, m = trainer._train_step(state, *batch)
        jax.block_until_ready(m["loss"])
        windows.append((time.perf_counter() - t0) / STEPS)
    dt = float(np.median(windows))
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise SystemExit(f"bench: non-finite loss {loss}")
    flops = train_step_flops(mcfg, len(vocab), BATCH, feat_cfg.num_frames(n))
    print(json.dumps({
        "metric": "conformer_m_30s_train_audio_seconds_per_second",
        "value": BATCH * SECONDS / dt,
        "unit": "audio-s/s",
        "ms_per_step": dt * 1e3,
        "ms_per_step_windows": [w * 1e3 for w in windows],
        "setup_s": setup_s,
        "mfu": flops / dt / peak_flops(dev.device_kind),
        "flops_per_step": flops,
        "loss": loss,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
