"""Model tests: shapes, masking invariance, param counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC, count_params
from nn_conformer_for_speech_recognition_tpu.models.conformer import (
    ConformerEncoder,
    MaskedBatchNorm,
    length_mask,
)
from nn_conformer_for_speech_recognition_tpu.models.subsampling import ConvSubsampling


def _tiny_model():
    enc = C.ConformerConfig(num_blocks=2, d_model=32, num_heads=2, ffn_dim=64,
                            conv_kernel_size=7, dropout=0.0)
    dec = C.DecoderConfig(projection_dim=16, lstm_hidden=16, dropout=0.0)
    return C.ModelConfig(encoder=enc, decoder=dec, n_mels=8)


def test_subsampling_lengths(rng):
    cfg = C.SubsamplingConfig(channels=(8, 8))
    m = ConvSubsampling(cfg, d_model=16)
    x = jnp.asarray(rng.standard_normal((2, 33, 8)).astype(np.float32))
    params = m.init(jax.random.key(0), x, jnp.array([33, 10]))
    out, lengths = m.apply(params, x, jnp.array([33, 10]))
    assert out.shape == (2, 9, 16)  # ceil(ceil(33/2)/2) = 9
    assert int(lengths[0]) == 9 and int(lengths[1]) == 3
    assert cfg.subsampled_length(33) == 9


def test_masked_batchnorm_ignores_padding(rng):
    m = MaskedBatchNorm()
    x = jnp.asarray(rng.standard_normal((2, 6, 4)).astype(np.float32))
    mask = length_mask(jnp.array([6, 3]), 6)
    vars_ = m.init(jax.random.key(0), x, mask)
    # corrupt padding: stats must not change
    x2 = x.at[1, 3:].set(1e6)
    y1, s1 = m.apply(vars_, x, mask, mutable=["batch_stats"])
    y2, s2 = m.apply(vars_, x2, mask, mutable=["batch_stats"])
    np.testing.assert_allclose(np.asarray(y1[0]), np.asarray(y2[0]), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(s1["batch_stats"]["mean"]), np.asarray(s2["batch_stats"]["mean"]), atol=1e-4
    )


def test_encoder_padding_invariance(rng):
    """Extending padding must not change valid-frame outputs."""
    cfg = C.ConformerConfig(num_blocks=1, d_model=16, num_heads=2, ffn_dim=32,
                            conv_kernel_size=5, dropout=0.0)
    m = ConformerEncoder(cfg)
    x8 = jnp.asarray(rng.standard_normal((1, 8, 16)).astype(np.float32))
    x12 = jnp.concatenate([x8, jnp.ones((1, 4, 16))], axis=1)
    lengths = jnp.array([8])
    params = m.init(jax.random.key(0), x8, lengths)
    y8 = m.apply(params, x8, lengths, deterministic=True)
    y12 = m.apply(params, x12, lengths, deterministic=True)
    np.testing.assert_allclose(np.asarray(y8), np.asarray(y12[:, :8]), atol=1e-4)
    np.testing.assert_allclose(np.asarray(y12[:, 8:]), 0.0, atol=1e-6)


def test_asr_forward_shapes(rng):
    cfg = _tiny_model()
    model = ConformerCTC(cfg, vocab_size=11)
    feats = jnp.asarray(rng.standard_normal((2, 20, 8)).astype(np.float32))
    lengths = jnp.array([20, 12])
    variables = model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, feats, lengths
    )
    lp, out_lengths = model.apply(variables, feats, lengths, deterministic=True)
    assert lp.shape == (2, 5, 11)  # T/4
    assert int(out_lengths[0]) == 5 and int(out_lengths[1]) == 3
    # valid log-softmax rows
    s = np.exp(np.asarray(lp)).sum(-1)
    np.testing.assert_allclose(s[0], 1.0, atol=1e-4)


def test_asr_dropout_rng_changes_output(rng):
    cfg = _tiny_model()
    cfg = C.ModelConfig(
        encoder=C.ConformerConfig(num_blocks=1, d_model=32, num_heads=2, ffn_dim=64,
                                  conv_kernel_size=7, dropout=0.5),
        decoder=cfg.decoder, n_mels=8,
    )
    model = ConformerCTC(cfg, vocab_size=11)
    feats = jnp.asarray(rng.standard_normal((2, 20, 8)).astype(np.float32))
    lengths = jnp.array([20, 20])
    variables = model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, feats, lengths
    )
    out1, _ = model.apply(
        variables, feats, lengths, deterministic=False,
        rngs={"dropout": jax.random.key(2)}, mutable=["batch_stats"],
    )[0], None
    out2, _ = model.apply(
        variables, feats, lengths, deterministic=False,
        rngs={"dropout": jax.random.key(3)}, mutable=["batch_stats"],
    )[0], None
    assert not np.allclose(np.asarray(out1[0]), np.asarray(out2[0]))


def test_preset_param_counts():
    """Conformer-S ≈ 10M (BASELINE.json configs[0])."""
    cfg = C.conformer_s()
    model = ConformerCTC(cfg, vocab_size=1024)
    feats = jnp.zeros((1, 16, 40))
    variables = model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        feats, jnp.array([16]),
    )
    n = count_params(variables["params"])
    assert 6e6 < n < 20e6, n


def test_bf16_compute_dtype(rng):
    cfg = C.ModelConfig(
        encoder=C.ConformerConfig(num_blocks=1, d_model=32, num_heads=2, ffn_dim=64,
                                  conv_kernel_size=7, dropout=0.0),
        decoder=C.DecoderConfig(projection_dim=16, lstm_hidden=16, dropout=0.0),
        n_mels=8, compute_dtype="bfloat16",
    )
    model = ConformerCTC(cfg, vocab_size=11)
    feats = jnp.asarray(rng.standard_normal((2, 16, 8)).astype(np.float32))
    variables = model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        feats, jnp.array([16, 16]),
    )
    lp, _ = model.apply(variables, feats, jnp.array([16, 16]), deterministic=True)
    assert lp.dtype == jnp.float32  # final logits/log-probs stay f32
    assert np.isfinite(np.asarray(lp)).all()


def test_remat_matches_plain(rng):
    """remat changes memory, not values or gradients."""
    def build(remat):
        enc = C.ConformerConfig(num_blocks=2, d_model=16, num_heads=2, ffn_dim=32,
                                conv_kernel_size=5, dropout=0.0)
        cfg = C.ModelConfig(encoder=enc,
                            decoder=C.DecoderConfig(projection_dim=8, lstm_hidden=8,
                                                    dropout=0.0),
                            n_mels=8, remat=remat)
        return ConformerCTC(cfg, vocab_size=7)

    feats = jnp.asarray(rng.standard_normal((2, 16, 8)).astype(np.float32))
    lens = jnp.array([16, 16])
    m0, m1 = build(False), build(True)
    params = m0.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                     feats, lens)
    out0, _ = m0.apply(params, feats, lens, deterministic=True)
    out1, _ = m1.apply(params, feats, lens, deterministic=True)
    np.testing.assert_allclose(np.asarray(out0), np.asarray(out1), atol=1e-5)

    def loss(m):
        def f(p):
            lp, _ = m.apply(p, feats, lens, deterministic=True)
            return jnp.sum(lp ** 2)
        return jax.grad(f)(params)

    g0, g1 = loss(m0), loss(m1)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_rel_shift_matches_gather_and_adjoint(rng):
    import jax
    import jax.numpy as jnp

    from nn_conformer_for_speech_recognition_tpu.ops.relshift import (
        rel_shift,
        rel_shift_adjoint,
    )

    b, h, t = 2, 3, 7
    x = jnp.asarray(rng.standard_normal((b, h, t, 2 * t - 1)).astype(np.float32))
    idx = (jnp.arange(t)[None, :] - jnp.arange(t)[:, None]) + (t - 1)
    ref = jnp.take_along_axis(x, jnp.broadcast_to(idx, (b, h, t, t)), axis=-1)
    np.testing.assert_array_equal(np.asarray(rel_shift(x)), np.asarray(ref))

    # adjointness: <rel_shift(x), y> == <x, rel_shift_adjoint(y)>
    y = jnp.asarray(rng.standard_normal((b, h, t, t)).astype(np.float32))
    lhs = jnp.vdot(rel_shift(x), y)
    rhs = jnp.vdot(x, rel_shift_adjoint(y))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-6)

    # and it equals the autodiff transpose of rel_shift
    _, vjp = jax.vjp(rel_shift, x)
    np.testing.assert_allclose(
        np.asarray(vjp(y)[0]), np.asarray(rel_shift_adjoint(y)), atol=1e-7
    )


def _param_paths(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in flat
    }


@pytest.mark.parametrize("norm", ["batchnorm", "groupnorm", "layernorm"])
def test_param_tree_pinned_per_conv_norm(rng, norm):
    """The parameter paths a checkpoint holds: one 'depthwise' Conv per
    block (biasless before BatchNorm, whose mean subtraction makes a bias
    inert), the packed per-direction BiLSTM weights, and the head."""
    mcfg = _tiny_model()
    mcfg = C.ModelConfig(
        encoder=C.ConformerConfig(num_blocks=2, d_model=32, num_heads=2, ffn_dim=64,
                                  conv_kernel_size=7, dropout=0.0, conv_norm=norm),
        decoder=mcfg.decoder, n_mels=mcfg.n_mels,
    )
    model = ConformerCTC(mcfg, vocab_size=11)
    feats = jnp.asarray(rng.standard_normal((2, 16, 8)).astype(np.float32))
    lens = jnp.array([16, 9])
    variables = model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, feats, lens
    )
    paths = _param_paths(variables["params"])
    dw = {p for p in paths if "/depthwise/" in p}
    want_bias = norm != "batchnorm"
    assert dw == {f"encoder/block_{i}/conv/depthwise/{n}" for i in range(2)
                  for n in (("kernel", "bias") if want_bias else ("kernel",))}
    assert {f"decoder_lstm/lstm_{d}_0_{w}" for d in ("fwd", "bwd")
            for w in ("w_ih", "w_hh", "bias")} <= paths
    assert {"final_fc/kernel", "final_fc/bias", "projection/kernel"} <= paths
    assert variables["params"]["encoder"]["block_0"]["conv"]["depthwise"]["kernel"].shape == (7, 1, 64)
