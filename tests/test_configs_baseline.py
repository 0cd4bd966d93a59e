"""Coverage for BASELINE.json's config matrix (shapes/rules level; full runs
live in examples/ and chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.data.vocab import WordPieceVocab
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC, count_params
from nn_conformer_for_speech_recognition_tpu.ops.decode import ctc_beam_search
from nn_conformer_for_speech_recognition_tpu.parallel import mesh as pmesh


def test_beam_search_with_wordpiece_vocab(rng):
    """configs[2]: beam decode over a word-piece vocab, end to end to text."""
    v = WordPieceVocab.build(
        ["go stop yes no", "going stopped", "yes yes no"], ntokens=64, min_freq=1
    )
    vocab_size = len(v)
    t = 12
    # logits peaked on the piece sequence for "go stop" with blanks between
    ids = v.parse("go stop")
    path = []
    for i in ids:
        path += [i, v.blank_id]
    path += [v.blank_id] * (t - len(path))
    logits = np.full((1, t, vocab_size), -8.0, np.float32)
    for f, c in enumerate(path[:t]):
        logits[0, f, c] = 8.0
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    toks, lens, scores = ctc_beam_search(
        lp, blank_id=v.blank_id, beam=8, prune=8, max_label_len=16
    )
    best = [int(x) for x in np.asarray(toks)[0, 0, : int(lens[0, 0])]]
    assert v.decode_ids(best) == "go stop"


def test_conformer_m_forward(rng):
    """configs[2-3]: Conformer-M builds and runs (tiny time dim)."""
    cfg = C.conformer_m()
    model = ConformerCTC(cfg, vocab_size=2050)  # wmp_vocab.txt size
    feats = jnp.zeros((1, 16, 40))
    variables = jax.jit(model.init)(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        feats, jnp.array([16]),
    )
    n = count_params(variables["params"])
    assert 20e6 < n < 60e6, n
    lp, _ = model.apply(variables, feats, jnp.array([16]), deterministic=True)
    assert lp.shape[-1] == 2050


def test_conformer_l_tp_sharding_rules():
    """configs[4]: Conformer-L (~100M) param shardings under model
    parallelism — abstract shapes only (eval_shape), no 100M-param init."""
    cfg = C.conformer_l()
    model = ConformerCTC(cfg, vocab_size=1024)
    feats = jax.ShapeDtypeStruct((1, 16, 40), jnp.float32)
    lens = jax.ShapeDtypeStruct((1,), jnp.int32)
    abstract = jax.eval_shape(
        lambda: model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            jnp.zeros((1, 16, 40)), jnp.zeros((1,), jnp.int32),
        )
    )
    params = abstract["params"]
    n = count_params(params)
    assert 70e6 < n < 200e6, n

    mesh_cfg = C.MeshConfig(model_parallel_size=2)
    mesh = pmesh.make_mesh(mesh_cfg)
    sh = pmesh.param_shardings(mesh, params, mesh_cfg)
    enc = sh["encoder"]
    # attention qkv column-sharded, out_proj row-sharded, on every block
    assert enc["block_0"]["mhsa"]["qkv"]["kernel"].spec == P(None, "model")
    assert enc["block_16"]["mhsa"]["out_proj"]["kernel"].spec == P("model", None)
    # ffn hidden dims sharded
    assert enc["block_0"]["ffn1"]["Dense_0"]["kernel"].spec == P(None, "model")
    # biases/norms replicated
    assert enc["block_0"]["mhsa"]["u_bias"].spec == P()
