"""Parallelism tests on the 8-device virtual CPU mesh (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.parallel import mesh as pmesh


def test_eight_virtual_devices():
    assert jax.device_count() == 8


def test_make_mesh_pure_dp():
    mesh = pmesh.make_mesh(C.MeshConfig())
    assert mesh.shape == {"data": 8, "model": 1}


def test_make_mesh_tp():
    mesh = pmesh.make_mesh(C.MeshConfig(model_parallel_size=2))
    assert mesh.shape == {"data": 4, "model": 2}


def test_batch_sharding_splits_batch():
    cfg = C.MeshConfig()
    mesh = pmesh.make_mesh(cfg)
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    (xs,) = pmesh.shard_batch_arrays(mesh, cfg, x)
    assert xs.sharding.spec == P("data")
    # each device holds 2 rows
    shard_shapes = {s.data.shape for s in xs.addressable_shards}
    assert shard_shapes == {(2, 4)}


def test_param_shardings_dp_replicated():
    cfg = C.MeshConfig()
    mesh = pmesh.make_mesh(cfg)
    params = {"mhsa": {"qkv": {"kernel": np.zeros((16, 48))}},
              "other": {"bias": np.zeros((4,))}}
    sh = pmesh.param_shardings(mesh, params, cfg)
    assert sh["mhsa"]["qkv"]["kernel"].spec == P()
    assert sh["other"]["bias"].spec == P()


def test_param_shardings_tp_rules():
    cfg = C.MeshConfig(model_parallel_size=2)
    mesh = pmesh.make_mesh(cfg)
    params = {
        "block_0": {
            "mhsa": {"qkv": {"kernel": np.zeros((16, 48))},
                      "out_proj": {"kernel": np.zeros((16, 16))}},
            "ffn1": {"Dense_0": {"kernel": np.zeros((16, 64))}},
            "conv": {"Dense_0": {"kernel": np.zeros((16, 31))}},  # odd: replicated
        }
    }
    sh = pmesh.param_shardings(mesh, params, cfg)
    b = sh["block_0"]
    assert b["mhsa"]["qkv"]["kernel"].spec == P(None, "model")
    assert b["mhsa"]["out_proj"]["kernel"].spec == P("model", None)
    assert b["ffn1"]["Dense_0"]["kernel"].spec == P(None, "model")
    assert b["conv"]["Dense_0"]["kernel"].spec == P()


def test_dp_grad_is_global_mean():
    """Sharded-batch loss grad == full-batch grad (GSPMD inserts the psum)."""
    cfg = C.MeshConfig()
    mesh = pmesh.make_mesh(cfg)
    w = jnp.ones((4, 4))
    x = np.random.default_rng(0).standard_normal((16, 4)).astype(np.float32)

    def loss(w, x):
        return jnp.mean((x @ w) ** 2)

    g_local = jax.grad(loss)(w, jnp.asarray(x))
    (xs,) = pmesh.shard_batch_arrays(mesh, cfg, x)
    ws = jax.device_put(w, pmesh.replicated(mesh))
    g_sharded = jax.jit(jax.grad(loss))(ws, xs)
    np.testing.assert_allclose(np.asarray(g_local), np.asarray(g_sharded), rtol=1e-5)


def test_sharded_model_forward_matches_single_device(rng):
    """Full ASR forward under DP sharding == unsharded forward."""
    from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC

    enc = C.ConformerConfig(num_blocks=1, d_model=16, num_heads=2, ffn_dim=32,
                            conv_kernel_size=5, dropout=0.0)
    dec = C.DecoderConfig(projection_dim=8, lstm_hidden=8, dropout=0.0)
    mcfg = C.ModelConfig(encoder=enc, decoder=dec, n_mels=8)
    model = ConformerCTC(mcfg, vocab_size=7)

    feats = jnp.asarray(rng.standard_normal((16, 12, 8)).astype(np.float32))
    lengths = jnp.full((16,), 12)
    variables = model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, feats, lengths
    )
    lp_ref, _ = model.apply(variables, feats, lengths, deterministic=True)

    cfg = C.MeshConfig()
    mesh = pmesh.make_mesh(cfg)
    vs = jax.device_put(variables, pmesh.replicated(mesh))
    fs, ls = pmesh.shard_batch_arrays(mesh, cfg, np.asarray(feats), np.asarray(lengths))
    lp_sh, _ = jax.jit(
        lambda v, f, l: model.apply(v, f, l, deterministic=True)
    )(vs, fs, ls)
    np.testing.assert_allclose(np.asarray(lp_ref), np.asarray(lp_sh), atol=2e-5)


def test_ulysses_attention_matches_local(rng):
    """Time-sharded Ulysses attention == single-device attention."""
    import jax.numpy as jnp
    from nn_conformer_for_speech_recognition_tpu.parallel.sequence import (
        _local_attention, ulysses_attention)

    mesh = pmesh.make_mesh(C.MeshConfig())  # 8-way 'data'
    b, t, h, dh = 2, 32, 8, 16  # T and H divisible by 8
    qu = jnp.asarray(rng.standard_normal((b, t, h, dh)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, t, h, dh)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((b, t, h, dh)).astype(np.float32))
    bias = jnp.asarray(rng.standard_normal((b, h, t, t)).astype(np.float32) * 0.1)
    lengths = jnp.array([32, 20])

    ref = _local_attention(qu, k, v, bias, lengths, 0.25)
    got = jax.jit(
        lambda *a: ulysses_attention(*a, scale=0.25, mesh=mesh, axis="data")
    )(qu, k, v, bias, lengths)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-5)


def _relpos_case(rng, b=2, t=32, h=8, dh=16):
    import jax.numpy as jnp

    mk = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32) * 0.5)
    q, k, v = mk(b, t, h, dh), mk(b, t, h, dh), mk(b, t, h, dh)
    p = mk(2 * t - 1, h, dh)
    u_bias, v_bias = mk(h, dh), mk(h, dh)
    mask = jnp.arange(t)[None, :] < jnp.array([t, t - 9])[:b, None]
    return q, k, v, p, u_bias, v_bias, mask


def _dense_relpos(q, k, v, p, u_bias, v_bias, mask, scale):
    """Replicated einsum reference (the model's dense branch)."""
    import jax.numpy as jnp
    from nn_conformer_for_speech_recognition_tpu.ops.relshift import rel_shift

    ac = jnp.einsum("bihd,bjhd->bhij", q + u_bias, k)
    bd = rel_shift(jnp.einsum("bihd,lhd->bhil", q + v_bias, p))
    scores = (ac + bd) * scale
    scores = jnp.where(mask[:, None, None, :], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhij,bjhd->bihd", probs, v)


@pytest.mark.parametrize("t", [32, 64])
def test_ulysses_relpos_attention_matches_dense(rng, t):
    """Product SP path (head-sharded rel-pos table, MeshConfig.seq_parallel)
    == dense rel-pos attention."""
    from nn_conformer_for_speech_recognition_tpu.parallel.sequence import (
        ulysses_relpos_attention,
    )

    mesh = pmesh.make_mesh(C.MeshConfig())
    q, k, v, p, u_bias, v_bias, mask = _relpos_case(rng, t=t)
    scale = 0.25
    ref = _dense_relpos(q, k, v, p, u_bias, v_bias, mask, scale)
    got = jax.jit(
        lambda *a: ulysses_relpos_attention(
            *a, scale=scale, mesh=mesh, axis="data"
        )
    )(q, k, v, p, u_bias, v_bias, mask)
    r, g = np.asarray(ref), np.asarray(got)
    np.testing.assert_allclose(g[0], r[0], atol=3e-5)
    np.testing.assert_allclose(g[1, : t - 9], r[1, : t - 9], atol=3e-5)


def test_ulysses_relpos_grads_match_dense(rng):
    """SP backward (all-to-all adjoints + head-sharded table grad) == dense."""
    from nn_conformer_for_speech_recognition_tpu.parallel.sequence import (
        ulysses_relpos_attention,
    )

    mesh = pmesh.make_mesh(C.MeshConfig())
    q, k, v, p, u_bias, v_bias, mask = _relpos_case(rng)
    scale = 0.25
    valid = mask[..., None, None]

    def loss_dense(q, k, v, p):
        out = _dense_relpos(q, k, v, p, u_bias, v_bias, mask, scale)
        return jnp.sum(jnp.where(valid, out, 0.0) ** 2)

    def loss_sp(q, k, v, p):
        out = ulysses_relpos_attention(
            q, k, v, p, u_bias, v_bias, mask, scale, mesh=mesh, axis="data"
        )
        return jnp.sum(jnp.where(valid, out, 0.0) ** 2)

    g_ref = jax.grad(loss_dense, argnums=(0, 1, 2, 3))(q, k, v, p)
    g_sp = jax.jit(jax.grad(loss_sp, argnums=(0, 1, 2, 3)))(q, k, v, p)
    for name, a, b in zip("qkvp", g_sp, g_ref):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=5e-4, err_msg=name
        )


def test_seq_parallel_trainer_step(rng, monkeypatch):
    """E2E train step with MeshConfig.seq_parallel on the 8-device mesh:
    the Ulysses path actually engages, and the loss matches a non-SP trainer
    bit-for-bit (same seeds, deterministic graph modulo the all-to-alls)."""
    from nn_conformer_for_speech_recognition_tpu.data.vocab import WordVocab
    from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu.parallel import sequence as S
    from nn_conformer_for_speech_recognition_tpu.train.loop import Trainer

    # 15872 samples → 32 frames → 8 post-subsampling (stride 4) — divisible
    # by the 8-way mesh so the SP path engages in the actual train step
    n_samp = 512 * 31
    enc = C.ConformerConfig(num_blocks=1, d_model=16, num_heads=8, ffn_dim=32,
                            conv_kernel_size=5, dropout=0.0)
    dec = C.DecoderConfig(projection_dim=8, lstm_hidden=8, dropout=0.0)
    mcfg = C.ModelConfig(encoder=enc, decoder=dec, n_mels=40)
    vocab = WordVocab(["<blank>", "<pad>", "<unk>", "a", "b", "c"])
    feat_cfg = C.FeatureConfig()
    train_cfg = C.TrainConfig(batch_size=8, use_specaugment=False)
    audio = rng.standard_normal((8, n_samp)).astype(np.float32) * 0.1
    alen = np.full((8,), n_samp, np.int32)
    tgts = np.full((8, 2), vocab.pad_id, np.int32)
    tgts[:, 0] = 3
    tlen = np.ones((8,), np.int32)

    calls = {"n": 0}
    orig = S.ulysses_relpos_attention

    def spy(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(S, "ulysses_relpos_attention", spy)
    # conformer.py imports the symbol at call time from the module, so the
    # monkeypatch is visible
    model = ConformerCTC(mcfg, vocab_size=len(vocab))
    try:
        tr_sp = Trainer(model, vocab, feat_cfg, train_cfg,
                        C.MeshConfig(seq_parallel=True))
        tr_sp.init_state(seed=0)
        calls["n"] = 0  # count only the train step's trace, not init's
        state_sp, m_sp = tr_sp._train_step(tr_sp.state, audio, alen, tgts, tlen)
        assert calls["n"] > 0, "SP path did not engage in the train step"
    finally:
        S.set_sequence_mesh(None)

    tr = Trainer(model, vocab, feat_cfg, train_cfg, C.MeshConfig())
    tr.init_state(seed=0)
    state, m = tr._train_step(tr.state, audio, alen, tgts, tlen)
    assert np.isfinite(float(m_sp["loss"]))
    np.testing.assert_allclose(float(m_sp["loss"]), float(m["loss"]), atol=1e-5)


def test_trainer_dp_step_matches_single_device(rng):
    """One Trainer step with the batch sharded over the 8-device mesh equals
    the same global batch stepped on one device: loss and updated params
    (the CPU form of `chip_smoke.py --four-cards`)."""
    import optax

    from nn_conformer_for_speech_recognition_tpu.data.vocab import WordVocab
    from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu.train.loop import Trainer

    enc = C.ConformerConfig(num_blocks=1, d_model=16, num_heads=2, ffn_dim=32,
                            conv_kernel_size=5, dropout=0.0)
    dec = C.DecoderConfig(projection_dim=8, lstm_hidden=8, dropout=0.0)
    mcfg = C.ModelConfig(encoder=enc, decoder=dec, n_mels=40)
    vocab = WordVocab(["<blank>", "<pad>", "<unk>", "a", "b", "c"])
    train_cfg = C.TrainConfig(batch_size=8, use_specaugment=False, donate_state=False)
    audio = rng.standard_normal((8, 4096)).astype(np.float32) * 0.1
    alen = np.full((8,), 4096, np.int32)
    alen[3] = 3000
    tgts = np.full((8, 2), vocab.pad_id, np.int32)
    tgts[:, 0] = 3 + rng.integers(0, 3, size=8)
    tlen = np.ones((8,), np.int32)
    out = []
    for devices in (jax.devices(), jax.devices()[:1]):
        mesh = pmesh.make_mesh(C.MeshConfig(), devices=devices)
        tr = Trainer(ConformerCTC(mcfg, vocab_size=len(vocab)), vocab, C.FeatureConfig(),
                     train_cfg, C.MeshConfig(), mesh=mesh, log_fn=lambda s: None)
        tr.tx = optax.sgd(1.0)  # the update is the gradient itself
        tr.init_state(seed=0)
        args = pmesh.shard_batch_arrays(mesh, C.MeshConfig(), audio, alen, tgts, tlen)
        state, m = tr._train_step(tr.state, *args)
        out.append((float(m["loss"]), state.params))
    (l8, p8), (l1, p1) = out
    assert np.isfinite(l8)
    np.testing.assert_allclose(l8, l1, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(p8), jax.tree.leaves(p1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
