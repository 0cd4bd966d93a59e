"""backend.routes: the platform → route table, and the main path's imports."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.backend import routes
from nn_conformer_for_speech_recognition_tpu.utils.rng import resolve_dropout_rng_impl

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,dtype,rng_impl", [
    ("gpu", "bfloat16", "rbg"),
    ("cpu", "float32", "threefry"),
])
def test_routes_per_platform(platform, dtype, rng_impl):
    r = routes(platform)
    assert (r.compute_dtype, r.dropout_rng) == (dtype, rng_impl)
    assert C.ModelConfig(compute_dtype="auto").resolved_compute_dtype() == (
        routes().compute_dtype)
    assert resolve_dropout_rng_impl(r.dropout_rng) == rng_impl


def test_unknown_platform_is_an_error():
    with pytest.raises(ValueError, match="no routes for platform 'rocm'"):
        routes("rocm")


def test_auto_choices_follow_the_platform_in_use():
    """Here (CPU): auto dtype float32, threefry dropout; under a default
    device the device's platform decides."""
    assert routes().compute_dtype == "float32"
    assert C.ModelConfig().resolved_compute_dtype() == "float32"
    assert resolve_dropout_rng_impl("auto") == "threefry"
    with jax.default_device(jax.devices("cpu")[0]):
        assert routes() == routes("cpu")
    with jax.default_device("cpu"):
        assert routes() == routes("cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        C.ModelConfig(compute_dtype="fp8").resolved_compute_dtype()


_BLOCKED_RUN = r"""
import sys
for name in ("flax", "orbax", "orbax.checkpoint", "matplotlib", "tensorflow",
             "tensorflow_datasets"):
    sys.modules[name] = None  # any import of these raises ImportError
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.data.vocab import WordVocab
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu.nst.driver import run_nst
from nn_conformer_for_speech_recognition_tpu.train.checkpoint import save_state
from nn_conformer_for_speech_recognition_tpu.train.loop import Trainer

enc = C.ConformerConfig(num_blocks=1, d_model=16, num_heads=2, ffn_dim=32,
                        conv_kernel_size=5, dropout=0.1)
dec = C.DecoderConfig(projection_dim=8, lstm_hidden=8, dropout=0.1)
mcfg = C.ModelConfig(encoder=enc, decoder=dec, n_mels=40)
vocab = WordVocab(["<blank>", "<pad>", "<unk>", "a", "b"])
tr = Trainer(ConformerCTC(mcfg, vocab_size=len(vocab)), vocab, C.FeatureConfig(),
             C.TrainConfig(batch_size=2), log_fn=lambda s: None)
tr.init_state(seed=0)
audio = np.random.default_rng(0).standard_normal((2, 4096)).astype(np.float32)
state, m = tr._train_step(tr.state, audio, np.full((2,), 4096, np.int32),
                          np.array([[3, 4], [4, 1]], np.int32), np.array([2, 1], np.int32))
assert np.isfinite(float(m["loss"]))
blocked = [n for n in ("flax", "orbax", "matplotlib", "tensorflow")
           if n in sys.modules and sys.modules[n] is not None]
assert not blocked, blocked
print("main path ok")
"""


def test_main_path_runs_without_optional_packages():
    """The model, train step, checkpoints and NST driver import and run with
    flax, orbax, matplotlib and tensorflow unavailable."""
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "main path ok" in out.stdout
