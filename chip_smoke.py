"""Smoke test: the Conformer-CTC train step and the NST pseudo-label pass on
NVIDIA GPUs, through the entry points a user calls (`Trainer`,
`nst.driver.run_nst`), at Conformer-M's full width (16 blocks, d=256).

    python chip_smoke.py               # one card: device, parity, train, nst
    python chip_smoke.py --measure     # also: threefry-dropout step time and
                                       # the 240 s remat step's memory
    python chip_smoke.py --four-cards  # four cards: DP train step + sharded
                                       # pseudo-label pass, against one card

Each phase raises on a failed check; the script then exits non-zero and
prints no result line.  Without a GPU it fails in phase ``device`` (there is
no CPU fallback).  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Everything runs in this one process, so one process holds each card.

A Conformer-M train-step compile takes minutes, so the default run compiles
each program once and keeps to about ten minutes; ``--measure`` adds two
more compiles.  ``--four-cards`` cuts the depth to ``FOUR_CARD_BLOCKS``
blocks (full width), since it checks agreement, not speed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Conformer-M training shapes: 30 s clips at 16 kHz, hop 512 → T=938 frames,
# T'=235 after 4x subsampling; word-piece-sized vocabulary; 100-token targets
BATCH = 16
SECONDS = 30.0
VOCAB = 1024
TARGET_LEN = 100
LONG_SECONDS = 240.0  # long-form clip for the remat memory check
STEPS = 10
FOUR_CARD_BLOCKS = 2

_failures: list = []


def check(ok: bool, what: str) -> None:
    """Record a failed check; the phase raises after printing all numbers."""
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        _failures.append(what)


def end_phase(name: str) -> None:
    if _failures:
        raise SystemExit(f"chip_smoke: phase {name} failed: {_failures}")
    print(f"phase {name}: ok", flush=True)


def timed_ms(fn, *args, n: int = 20) -> float:
    """Median wall time of ``fn(*args)`` in ms, each call ended with
    ``block_until_ready``; the first (compiling) call is not counted."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# phase device
# ---------------------------------------------------------------------------


def phase_device(min_count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, JAX found platform "
            f"{devs[0].platform!r}"
        )
    if len(devs) < min_count:
        raise SystemExit(f"chip_smoke: needs {min_count} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(f"device_kind: {devs[0].device_kind}, count: {len(devs)}")
    for line in smi:
        print(f"card: {line}")
    print(f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
          f"JAX_COMPILATION_CACHE_DIR={os.environ.get('JAX_COMPILATION_CACHE_DIR')!r}")
    for pkg in ("flax", "orbax", "matplotlib", "tensorflow"):
        found = importlib.util.find_spec(pkg) is not None
        print(f"  optional package {pkg}: {'installed' if found else 'absent'}")
    print("phase device: ok", flush=True)
    return devs


# ---------------------------------------------------------------------------
# phase parity
# ---------------------------------------------------------------------------


def phase_parity():
    import jax
    import jax.numpy as jnp

    from nn_conformer_for_speech_recognition_tpu import config as C
    from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu.ops import lstm
    from nn_conformer_for_speech_recognition_tpu.ops.ctc import ctc_loss
    from nn_conformer_for_speech_recognition_tpu.ops.features import log_mel_spectrogram

    rng = np.random.default_rng(0)
    mcfg = C.conformer_m()

    # -- BiLSTM scan against JAX's plain LSTM reference (torch.nn.LSTM
    # semantics), decoder widths of Conformer-M, ragged lengths
    from jax.experimental import rnn

    b, t = BATCH, mcfg.subsampled_length(C.FeatureConfig().num_frames(int(SECONDS * 16000)))
    d, h = mcfg.decoder.projection_dim, mcfg.decoder.lstm_hidden
    mk = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    x = mk(b, t, d)
    dirs = tuple((mk(d, 4 * h) * 0.06, mk(h, 4 * h) * 0.06, mk(4 * h) * 0.1)
                 for _ in range(2))
    lens = jnp.asarray(np.maximum(t - 13 * np.arange(b), 1).astype(np.int32))
    cot = mk(b, t, 2 * h)

    def scan(x, dirs, dtype=jnp.float32):
        return jnp.concatenate(
            [lstm.lstm_scan(x, dirs[0], lens, dtype=dtype),
             lstm.lstm_scan(x, dirs[1], lens, reverse=True, dtype=dtype)], -1)

    def ref(x, dirs):
        tr = lambda i: {0: dirs[0][i].T, 1: dirs[1][i].T} if i < 2 else \
            {0: dirs[0][2], 1: dirs[1][2]}
        zb = {k: jnp.zeros_like(v) for k, v in tr(2).items()}
        h0 = jnp.zeros((2, b, h))
        return rnn.lstm_ref(x, h0, h0, tr(0), tr(1), tr(2), zb, lens, d, h, 1, 0.0, True)[0]

    def grads(f):
        return jax.jit(jax.grad(lambda x, w: jnp.sum(f(x, w) * cot), argnums=(0, 1)))(x, dirs)

    # f32 reference: full-precision products (the card otherwise uses TF32);
    # 1e-4 relative (max error over max magnitude) allows f32 reassociation
    # across 235 recurrent steps
    with jax.default_matmul_precision("highest"):
        y_s, y_r = jax.jit(scan)(x, dirs), ref(x, dirs)
        g_s, g_r = grads(scan), grads(ref)
    e = rel_err(y_s, y_r)
    check(e < 1e-4, f"LSTM scan vs lstm_ref, f32-highest, outputs: rel err {e:.2e} < 1e-4")
    for name, a, r in zip(("dx", "dW"), g_s, g_r):
        e = max(rel_err(u, v) for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(r)))
        check(e < 1e-4, f"LSTM scan vs lstm_ref, f32-highest, {name}: rel err {e:.2e} < 1e-4")
    # the bf16 model route: bf16 operands (8-bit mantissa, 2^-8 relative
    # rounding per product) through 235 steps, f32 carry
    y_b = jax.jit(lambda x, w: scan(x, w, jnp.bfloat16))(x, dirs)
    e = rel_err(y_b, y_r)
    check(e < 3e-2, f"LSTM scan bf16 vs lstm_ref f32, outputs: rel err {e:.2e} < 3e-2")

    # -- Conformer-M forward: GPU against the CPU backend, f32-highest, two
    # 30 s clips.  Largest log-prob gap 1e-3: both sides are f32 with full-
    # precision products, so only reassociation differs
    fcfg = C.FeatureConfig()
    n = int(SECONDS * fcfg.sample_rate)
    audio = rng.standard_normal((2, n)).astype(np.float32) * 0.1
    alen = np.array([n, n - 7 * fcfg.sample_rate], np.int32)
    model = ConformerCTC(C.conformer_m(compute_dtype="float32"), vocab_size=VOCAB)

    def forward(variables, audio, alen):
        feats, flen = log_mel_spectrogram(audio, fcfg, alen)
        return model.apply(variables, feats, flen, deterministic=True)

    with jax.default_matmul_precision("highest"):
        feats, flen = log_mel_spectrogram(jnp.asarray(audio), fcfg, jnp.asarray(alen))
        variables = jax.jit(model.init)(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, feats, flen)
        lp_gpu, ol = jax.jit(forward)(variables, audio, alen)
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            lp_cpu, _ = jax.jit(forward)(jax.device_put(variables, cpu), audio, alen)
    valid = np.arange(lp_gpu.shape[1])[None, :] < np.asarray(ol)[:, None]
    gap = float(np.abs(np.asarray(lp_gpu) - np.asarray(lp_cpu))[valid].max())
    check(np.isfinite(np.asarray(lp_gpu)).all(), f"Conformer-M forward finite, shape {lp_gpu.shape}")
    check(gap < 1e-3, f"Conformer-M forward GPU vs CPU, f32-highest: max |log-prob gap| {gap:.2e} < 1e-3")

    # -- plain XLA times of the ops that used to have hand-written kernels
    fb = jnp.asarray(rng.standard_normal((BATCH, n)).astype(np.float32) * 0.1)
    fl = jnp.full((BATCH,), n, jnp.int32)
    ms = timed_ms(jax.jit(lambda a, l: log_mel_spectrogram(a, fcfg, l)), fb, fl)
    print(f"  time: featurizer (XLA matmul-DFT log-mel), B={BATCH}, {SECONDS:.0f} s: {ms:.3f} ms")
    lp = jax.nn.log_softmax(mk(BATCH, t, VOCAB), -1)
    labels = jnp.asarray(rng.integers(3, VOCAB, size=(BATCH, TARGET_LEN)).astype(np.int32))
    il = jnp.full((BATCH,), t, jnp.int32)
    tl = jnp.full((BATCH,), TARGET_LEN, jnp.int32)
    ctc_vg = jax.jit(jax.value_and_grad(
        lambda lp: jnp.sum(ctc_loss(lp, labels, il, tl, reduction=None))))
    ms = timed_ms(ctc_vg, lp)
    print(f"  time: CTC loss + gradient (lax.scan), B={BATCH}, T'={t}, L={TARGET_LEN}, "
          f"V={VOCAB}: {ms:.3f} ms")
    end_phase("parity")


# ---------------------------------------------------------------------------
# phase train
# ---------------------------------------------------------------------------


def _vocab(words=()):
    """A VOCAB-entry word vocabulary holding ``words``, padded with fillers."""
    from nn_conformer_for_speech_recognition_tpu.data.vocab import WordVocab

    words = list(words)
    fill = [f"w{i}" for i in range(VOCAB - 3 - len(words))]
    return WordVocab(["<blank>", "<pad>", "<unk>"] + words + fill)


def _train_cfg():
    from nn_conformer_for_speech_recognition_tpu import config as C

    return C.TrainConfig(batch_size=BATCH, optimizer=C.OptimizerConfig(learning_rate=1e-3),
                         log_every=0)


def _batch(rng, b, seconds, vocab_size):
    n = int(seconds * 16000)
    audio = rng.standard_normal((b, n)).astype(np.float32) * 0.1
    alen = np.full((b,), n, np.int32)
    tgt = rng.integers(3, vocab_size, size=(b, TARGET_LEN)).astype(np.int32)
    tlen = np.full((b,), TARGET_LEN, np.int32)
    return audio, alen, tgt, tlen


def _steady_step_ms(step, state, batch, n=STEPS):
    import jax

    state, m = step(state, *batch)
    jax.block_until_ready(m["loss"])
    t0 = time.perf_counter()
    losses = []
    for _ in range(n):
        state, m = step(state, *batch)
        losses.append(m["loss"])
    jax.block_until_ready(losses)
    return 1e3 * (time.perf_counter() - t0) / n, state, [float(v) for v in losses]


def phase_train(measure: bool):
    import jax

    from nn_conformer_for_speech_recognition_tpu import config as C
    from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu.parallel import mesh as pmesh
    from nn_conformer_for_speech_recognition_tpu.ops.features import log_mel_spectrogram
    from nn_conformer_for_speech_recognition_tpu.train.loop import Trainer

    vocab = _vocab()
    fcfg = C.FeatureConfig()
    mcfg = C.conformer_m(compute_dtype="bfloat16")
    model = ConformerCTC(mcfg, vocab_size=len(vocab))
    tcfg = _train_cfg()
    trainer = Trainer(model, vocab, fcfg, tcfg, log_fn=lambda s: None)
    trainer.init_state(seed=0)
    batch = pmesh.shard_batch_arrays(
        trainer.mesh, trainer.mesh_cfg, *_batch(np.random.default_rng(1), BATCH, SECONDS, len(vocab)))

    t0 = time.perf_counter()
    state, m = trainer._train_step(trainer.state, *batch)
    first = float(m["loss"])
    compile_s = time.perf_counter() - t0
    print(f"  first train step (compile + run), Conformer-M bf16 B={BATCH} {SECONDS:.0f} s: "
          f"{compile_s:.1f} s, loss {first:.4f}")
    check(np.isfinite(first), "first loss finite")

    feats, flen = jax.jit(lambda a, l: log_mel_spectrogram(a, fcfg, l))(batch[0], batch[1])
    compiled = trainer._train_core.lower(state, feats, flen, batch[2], batch[3]).compile()
    print(f"  memory_analysis (train core): {compiled.memory_analysis()}")

    ms, state, losses = _steady_step_ms(trainer._train_step, state, batch)
    print(f"  steady train step (rbg dropout): {ms:.2f} ms/step "
          f"({BATCH * SECONDS / ms * 1e3:.0f} audio-s/s); losses {losses[0]:.4f} → {losses[-1]:.4f}")
    check(all(np.isfinite(losses)), "losses finite")
    check(np.mean(losses[-3:]) < first, f"loss falls on a repeated batch ({first:.4f} → {np.mean(losses[-3:]):.4f})")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")

    ms_pred = timed_ms(trainer._predict_step, state, batch[0], batch[1])
    print(f"  pseudo-label pass step (featurize, forward, greedy decode), B={BATCH}: "
          f"{ms_pred:.2f} ms")
    if measure:
        _measure(trainer, state, batch)
    end_phase("train")


def _measure(trainer, state, batch):
    """Two more compiles: the threefry-dropout step, and the 240 s remat
    step (compile only, for its memory)."""
    import jax
    import jax.numpy as jnp

    from nn_conformer_for_speech_recognition_tpu import config as C
    from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu.train.loop import (
        make_augment_step,
        make_feature_train_step,
    )

    model, vocab, fcfg, tcfg = trainer.model, trainer.vocab, trainer.feat_cfg, trainer.train_cfg
    mcfg = model.config
    # dropout PRNG: threefry beside the default rbg, same step otherwise
    aug = jax.jit(make_augment_step(fcfg, tcfg.specaugment, True))
    core_tf = jax.jit(make_feature_train_step(model, vocab.blank_id, dropout_rng="threefry"),
                      donate_argnums=(0,))

    def step_tf(st, a, al, tg, tl):
        f, fl = aug(st.rng, a, al)
        return core_tf(st, f, fl, tg, tl)

    ms_tf, state, _ = _steady_step_ms(step_tf, state, batch)
    print(f"  steady train step (threefry dropout): {ms_tf:.2f} ms/step")

    # long-form memory: per-block remat at 240 s (T'=1876), compile only
    n_long = int(LONG_SECONDS * fcfg.sample_rate)
    t_long = fcfg.num_frames(n_long)
    remat_model = ConformerCTC(C.conformer_m(compute_dtype="bfloat16", remat=True),
                               vocab_size=len(vocab))
    core_remat = jax.jit(make_feature_train_step(remat_model, vocab.blank_id))
    sds = jax.ShapeDtypeStruct
    compiled = core_remat.lower(
        state, sds((BATCH, t_long, fcfg.n_mels), jnp.float32), sds((BATCH,), jnp.int32),
        sds((BATCH, TARGET_LEN), jnp.int32), sds((BATCH,), jnp.int32)).compile()
    print(f"  memory_analysis (remat train core, {LONG_SECONDS:.0f} s, T'="
          f"{mcfg.subsampled_length(t_long)}): {compiled.memory_analysis()}")


# ---------------------------------------------------------------------------
# phase nst
# ---------------------------------------------------------------------------


def phase_nst():
    from nn_conformer_for_speech_recognition_tpu import config as C
    from nn_conformer_for_speech_recognition_tpu.data.audio import make_synthetic_corpus
    from nn_conformer_for_speech_recognition_tpu.data.datasets import (
        BucketedDataset,
        load_manifest,
    )
    from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu.nst.driver import run_nst
    from nn_conformer_for_speech_recognition_tpu.train.loop import Trainer

    words = ["yes", "no", "go", "stop", "up", "down", "left", "right"]
    with tempfile.TemporaryDirectory() as tmp:
        man = make_synthetic_corpus(os.path.join(tmp, "corpus"), words, n_train=32,
                                    n_val=0, n_test=0, n_unlabeled=16, seed=0)
        sup_utts = load_manifest(man["train"])
        vocab = _vocab(words)

        # batches padded to the train phase's shapes (B, 30 s audio, 100
        # target slots, V) so the steps are the programs compiled there
        def ds(split):
            return BucketedDataset(load_manifest(man[split]), vocab, batch_size=BATCH,
                                   bucket_boundaries=[int(SECONDS * 16000)],
                                   max_target_len=TARGET_LEN)

        trainer = Trainer(ConformerCTC(C.conformer_m(compute_dtype="bfloat16"),
                                       vocab_size=len(vocab)),
                          vocab, C.FeatureConfig(), _train_cfg(), log_fn=lambda s: None)
        trainer.init_state(seed=0)
        labels_seen = []
        generate = trainer.generate_labels

        def spy(dataset, *a, **kw):
            out = generate(dataset, *a, **kw)
            labels_seen.append(out)
            return out

        trainer.generate_labels = spy
        unlabeled = ds("unlabeled")
        t0 = time.perf_counter()
        results = run_nst(trainer, ds("train"), unlabeled,
                          C.NSTConfig(generations=1, initial_supervised_finetune=False,
                                      max_target_len=4),
                          work_dir=os.path.join(tmp, "nst"))
        dt = time.perf_counter() - t0
        mix = open(os.path.join(tmp, "nst", "mix_gen0.tsv"), encoding="utf-8").read()
    (labels,) = labels_seen
    print(f"  run_nst: 1 generation in {dt:.1f} s (compiles included); {results[0]}")
    print(f"  sample pseudo-labels: {list(labels.items())[:4]}")
    check(len(labels) == len(unlabeled.utterances),
          f"pseudo-labelled {len(labels)}/{len(unlabeled.utterances)} unlabeled utterances")
    check(all(isinstance(s, str) for s in labels.values()), "pseudo-labels decode to strings")
    check(len(mix.splitlines()) >= len(sup_utts), "mix manifest written")
    check(int(trainer.state.step) >= 1, f"retrained {int(trainer.state.step)} steps")
    end_phase("nst")


# ---------------------------------------------------------------------------
# --four-cards
# ---------------------------------------------------------------------------


def phase_four_cards(devs):
    import jax
    import optax

    from nn_conformer_for_speech_recognition_tpu import config as C
    from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu.parallel import mesh as pmesh
    from nn_conformer_for_speech_recognition_tpu.train.loop import Trainer

    vocab = _vocab()
    fcfg = C.FeatureConfig()
    # dropout off and SpecAugment off so one step is a deterministic function
    # of (params, batch) on any device layout; f32 with full-precision
    # products so the comparison sees reduction order only.  The step uses
    # plain SGD so the parameter update is the gradient itself: Adafactor
    # divides each row of a factored update by that row's gradient RMS, and
    # rows whose gradient is tiny (pos_proj's low-frequency sinusoid inputs)
    # turn reduction-order noise into differences of order lr
    base = C.conformer_m(compute_dtype="float32")
    mcfg = dataclasses.replace(
        base,
        encoder=dataclasses.replace(base.encoder, dropout=0.0, num_blocks=FOUR_CARD_BLOCKS),
        decoder=dataclasses.replace(base.decoder, dropout=0.0),
    )
    print(f"  Conformer-M width, {FOUR_CARD_BLOCKS} of 16 blocks, f32, global batch "
          f"{4 * BATCH}, {SECONDS:.0f} s clips")
    tcfg = C.TrainConfig(batch_size=4 * BATCH, use_specaugment=False, donate_state=False)
    host = _batch(np.random.default_rng(2), 4 * BATCH, SECONDS, len(vocab))
    mesh_cfg = C.MeshConfig()
    out = {}
    with jax.default_matmul_precision("highest"):
        for name, devices in (("dp4", devs[:4]), ("one", devs[:1])):
            mesh = pmesh.make_mesh(mesh_cfg, devices=devices)
            tr = Trainer(ConformerCTC(mcfg, vocab_size=len(vocab)), vocab, fcfg, tcfg,
                         mesh_cfg, mesh=mesh, log_fn=lambda s: None)
            tr.tx = optax.sgd(1.0)
            tr.init_state(seed=0)
            batch = pmesh.shard_batch_arrays(mesh, mesh_cfg, *host)
            t0 = time.perf_counter()
            state, m = tr._train_step(tr.state, *batch)
            loss = float(m["loss"])
            print(f"  {name}: mesh {dict(mesh.shape)}, first step {time.perf_counter() - t0:.1f} s, "
                  f"loss {loss:.6f}")
            delta = jax.tree.map(lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
                                 state.params, tr.state.params)
            out[name] = (loss, delta, tr, state, batch)

    (l4, d4, tr4, st4, b4), (l1, d1, _, _, _) = out["dp4"], out["one"]
    e = abs(l4 - l1) / abs(l1)
    check(e < 1e-5, f"DP loss vs one card: rel diff {e:.2e} < 1e-5")
    num = np.sqrt(sum(float(np.sum((a - b) ** 2)) for a, b in zip(jax.tree.leaves(d4), jax.tree.leaves(d1))))
    den = np.sqrt(sum(float(np.sum(b ** 2)) for b in jax.tree.leaves(d1)))
    # f32 sums of 64 examples' gradients in another order: 1e-4 relative
    check(num / den < 1e-4,
          f"DP param update vs one card (SGD, lr 1): |Δ4 - Δ1| / |Δ1| = {num / den:.2e} < 1e-4")
    mx = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree.leaves(d4), jax.tree.leaves(d1)))
    big = max(float(np.abs(b).max()) for b in jax.tree.leaves(d1))
    print(f"  largest single-parameter update difference: {mx:.2e} (largest update {big:.2e})")

    ids, _ = tr4._predict_step(st4, b4[0], b4[1])
    devices = {s.device for s in ids.addressable_shards}
    rows = {s.index[0].stop - s.index[0].start for s in ids.addressable_shards}
    check(len(devices) == 4 and rows == {BATCH},
          f"sharded pseudo-label pass: {len(devices)} shards, rows per shard {rows}")
    labels = [vocab.decode_ids(np.asarray(r)) for r in np.asarray(ids)]
    check(len(labels) == 4 * BATCH and all(isinstance(s, str) for s in labels),
          "pseudo-labels decode to strings")
    end_phase("four_cards")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card DP train step and sharded "
                        "pseudo-label pass, against one card")
    p.add_argument("--measure", action="store_true",
                   help="also time the threefry-dropout step and compile the "
                        "240 s remat step for its memory (two more compiles)")
    args = p.parse_args(argv)
    devs = phase_device(4 if args.four_cards else 1)
    if args.four_cards:
        phase_four_cards(devs)
        count = 4
    else:
        phase_parity()
        phase_train(args.measure)
        phase_nst()
        count = len(devs)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
