"""Run the SpeechCommands parity pipeline at REFERENCE SCALE (VERDICT r4 #7).

The real-data parity run stays blocked (no datasets in the image), but its
first failure mode — RAM/wall-clock in manifest loading, featurization and
the data pipeline at 63,340 train clips (`main.ipynb` cell 33) — is testable
today: this script synthesizes a SpeechCommands-geometry corpus (1 s clips,
the reference's 35 command words) at full scale and runs the parity protocol
(`parity.run_parity`) end-to-end through the STREAMING path
(`data/streaming.StreamingDataset`: no RAM audio cache, bounded queue).

Epoch count is reduced (default 3 supervised + 1 NST generation — override
with PARITY_SCALE_EPOCHS / PARITY_SCALE_GENS): the pipeline risk is
per-epoch, and the full 15-epoch wall-clock is extrapolated from the
measured per-epoch cost in the output.

Writes results/parity_scale.json (corpus counts, per-stage wall/RSS,
per-stage throughput, extrapolation).

Run: JAX_PLATFORMS='' python examples/parity_scale.py
"""

import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

N_TRAIN = 63_340  # main.ipynb cell 33
N_VAL = 4_886
N_TEST = 4_890
N_UNLABELED = 16_000
CORPUS = os.environ.get("PARITY_SCALE_CORPUS", "/tmp/parity_scale_corpus")
WORK = os.environ.get("PARITY_SCALE_WORK", "/tmp/parity_scale_work")
EPOCHS = int(os.environ.get("PARITY_SCALE_EPOCHS", "3"))
GENS = int(os.environ.get("PARITY_SCALE_GENS", "1"))

# the reference's 35 command words (vocabs/myvocab.txt order-free)
WORDS = [
    "yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go",
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "bed", "bird", "cat", "dog", "happy", "house", "marvin",
    "sheila", "tree", "wow", "backward", "forward", "follow", "learn",
    "visual",
]


def ensure_corpus():
    from nn_conformer_for_speech_recognition_tpu.data.audio import (
        make_synthetic_corpus,
    )

    marker = os.path.join(CORPUS, "COMPLETE.json")
    if os.path.exists(marker):
        return json.loads(open(marker).read()), 0.0
    t0 = time.perf_counter()
    man = make_synthetic_corpus(
        CORPUS, WORDS, n_train=N_TRAIN, n_val=N_VAL, n_test=N_TEST,
        n_unlabeled=N_UNLABELED, seed=0,
    )
    gen_s = time.perf_counter() - t0
    with open(marker, "w") as f:
        json.dump(man, f)
    return man, gen_s


def main():
    import jax

    backend = jax.default_backend()
    print(f"[parity-scale] backend={backend}", flush=True)

    man, gen_s = ensure_corpus()
    manifest_dir = CORPUS
    n_wavs = N_TRAIN + N_VAL + N_TEST + N_UNLABELED
    print(f"[parity-scale] corpus ready ({n_wavs} wavs, gen {gen_s:.0f}s)",
          flush=True)

    from nn_conformer_for_speech_recognition_tpu.parity import run_parity

    t0 = time.perf_counter()
    results = run_parity(
        manifest_dir, WORK, epochs=EPOCHS, generations=GENS,
        streaming=True,
    )
    total_s = time.perf_counter() - t0

    stages = results.get("stages", {})
    sup = stages.get("supervised_train", {}).get("wall_s", 0.0)
    per_epoch_s = sup / max(EPOCHS, 1)
    steps_per_epoch = -(-N_TRAIN // 32)
    out = {
        "backend": backend,
        "corpus": {"train": N_TRAIN, "validation": N_VAL, "test": N_TEST,
                   "unlabeled": N_UNLABELED, "clip_seconds": 1.0,
                   "generate_s": round(gen_s, 1)},
        "protocol": {"epochs": EPOCHS, "generations": GENS,
                     "batch_size": 32, "streaming": True},
        "stages": stages,
        "throughput": {
            "supervised_steps_per_s": round(
                steps_per_epoch * EPOCHS / sup, 2) if sup else None,
            "supervised_audio_s_per_s": round(
                N_TRAIN * EPOCHS / sup, 1) if sup else None,
            "per_epoch_s": round(per_epoch_s, 1),
        },
        "extrapolated_full_protocol_s": round(
            per_epoch_s * 15
            + stages.get("base_eval", {}).get("wall_s", 0.0)
            + (stages.get("nst", {}).get("wall_s", 0.0) / max(GENS, 1)) * 3
            + stages.get("nst_eval", {}).get("wall_s", 0.0), 1),
        "wer": results.get("wer", {}),
        "total_wall_s": round(total_s, 1),
        "note": "synthetic corpus at reference scale (main.ipynb cell 33 "
                "counts); WERs are pipeline-health signals, not reference "
                "comparisons. reduced epochs; full-protocol wall-clock "
                "extrapolated from per-epoch cost.",
    }
    path = pathlib.Path(__file__).resolve().parent.parent / "results" / "parity_scale.json"
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out, indent=1), flush=True)
    print("wrote", path, flush=True)


if __name__ == "__main__":
    main()
