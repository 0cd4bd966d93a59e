"""models/layers.py: the module system and each layer against numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nn_conformer_for_speech_recognition_tpu.models import layers as nn
from nn_conformer_for_speech_recognition_tpu.models.conformer import (
    MaskedBatchNorm,
    length_mask,
)


def _init_apply(module, *args, **kw):
    variables = module.init({"params": jax.random.key(0)}, *args, **kw)
    return variables, module.apply(variables, *args, **kw)


def test_dense_matches_numpy(rng):
    x = rng.standard_normal((3, 5, 7)).astype(np.float32)
    v, y = _init_apply(nn.Dense(4), jnp.asarray(x))
    p = v["params"]
    ref = x @ np.asarray(p["kernel"]) + np.asarray(p["bias"])
    assert p["kernel"].shape == (7, 4)
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-5)


def _conv_ref(x, w, stride, groups):
    """Channels-last 'SAME' convolution over the spatial axes of x, in numpy
    loops: x (B, *S, Cin), w (*K, Cin/groups, Cout)."""
    nd = x.ndim - 2
    ks = w.shape[:nd]
    pads = []
    for n, k, s in zip(x.shape[1:-1], ks, stride):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    xp = np.pad(x, [(0, 0)] + pads + [(0, 0)])
    outs = [-(-n // s) for n, s in zip(x.shape[1:-1], stride)]
    cin_g = w.shape[nd]
    cout = w.shape[-1]
    cout_g = cout // groups
    y = np.zeros((x.shape[0], *outs, cout), np.float64)
    for idx in np.ndindex(*outs):
        sl = tuple(slice(i * s, i * s + k) for i, s, k in zip(idx, stride, ks))
        patch = xp[(slice(None),) + sl]  # (B, *K, Cin)
        for g in range(groups):
            pg = patch[..., g * cin_g:(g + 1) * cin_g]
            wg = w[..., g * cout_g:(g + 1) * cout_g]
            y[(slice(None),) + idx + (slice(g * cout_g, (g + 1) * cout_g),)] = np.tensordot(
                pg, wg, axes=(list(range(1, nd + 2)), list(range(nd + 1))))
    return y


@pytest.mark.parametrize("k,t", [(33, 40), (5, 17), (4, 9)])
def test_depthwise_conv_matches_numpy(rng, k, t):
    """The conv module's depthwise conv (feature_group_count = channels,
    'SAME' padding, odd and even kernels)."""
    c = 6
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    conv = nn.Conv(c, kernel_size=(k,), feature_group_count=c, use_bias=False)
    v, y = _init_apply(conv, jnp.asarray(x))
    w = np.asarray(v["params"]["kernel"])
    assert w.shape == (k, 1, c)
    np.testing.assert_allclose(np.asarray(y), _conv_ref(x, w, (1,), c), atol=1e-5)


def test_strided_conv2d_matches_numpy(rng):
    """The subsampling frontend's conv: 2-D, stride 2, with bias."""
    x = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    v, y = _init_apply(nn.Conv(4, kernel_size=(3, 3), strides=(2, 2)), jnp.asarray(x))
    p = v["params"]
    ref = _conv_ref(x, np.asarray(p["kernel"]), (2, 2), 1) + np.asarray(p["bias"])
    assert y.shape == (2, 5, 4, 4)
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-5)


def test_layernorm_matches_numpy(rng):
    x = rng.standard_normal((4, 6)).astype(np.float32) * 3 + 1
    v, y = _init_apply(nn.LayerNorm(), jnp.asarray(x))
    ref = (x - x.mean(-1, keepdims=True)) / np.sqrt(x.var(-1, keepdims=True) + 1e-6)
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-5)
    assert set(v["params"]) == {"scale", "bias"}


def test_groupnorm_matches_numpy(rng):
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    _, y = _init_apply(nn.GroupNorm(num_groups=4), jnp.asarray(x))
    g = x.reshape(2, 5, 4, 2)
    mean = g.mean(axis=(1, 3), keepdims=True)
    var = g.var(axis=(1, 3), keepdims=True)
    ref = ((g - mean) / np.sqrt(var + 1e-6)).reshape(x.shape)
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-5)


def test_masked_batchnorm_matches_numpy(rng):
    """Training mode normalises with valid-frame statistics and updates the
    running averages; inference mode uses the running averages."""
    x = rng.standard_normal((2, 6, 3)).astype(np.float32) * 2 + 1
    lens = np.array([6, 2])
    mask = length_mask(jnp.asarray(lens), 6)
    bn = MaskedBatchNorm()
    v = bn.init(jax.random.key(0), jnp.asarray(x), mask)
    y, upd = bn.apply(v, jnp.asarray(x), mask, mutable=["batch_stats"])
    valid = np.concatenate([x[0, :6], x[1, :2]])
    mean, var = valid.mean(0), valid.var(0)
    np.testing.assert_allclose(np.asarray(y), (x - mean) / np.sqrt(var + 1e-5), atol=1e-4)
    np.testing.assert_allclose(np.asarray(upd["batch_stats"]["mean"]), 0.1 * mean, atol=1e-5)
    np.testing.assert_allclose(np.asarray(upd["batch_stats"]["var"]), 0.9 + 0.1 * var, atol=1e-5)
    y_inf = bn.apply({**v, **upd}, jnp.asarray(x), mask, use_running_average=True)
    ref = (x - 0.1 * mean) / np.sqrt(0.9 + 0.1 * var + 1e-5)
    np.testing.assert_allclose(np.asarray(y_inf), ref, atol=1e-4)


def test_dropout_rate_scale_and_determinism():
    x = jnp.ones((64, 128))
    d = nn.Dropout(0.25)
    assert d.apply({}, x, deterministic=True) is x
    y = np.asarray(d.apply({}, x, deterministic=False, rngs={"dropout": jax.random.key(0)}))
    assert set(np.unique(y)) <= {0.0, np.float32(1 / 0.75)}
    assert abs((y == 0).mean() - 0.25) < 0.02
    y2 = np.asarray(d.apply({}, x, deterministic=False, rngs={"dropout": jax.random.key(0)}))
    np.testing.assert_array_equal(y, y2)  # same key, same mask
    with pytest.raises(ValueError, match="dropout"):
        d.apply({}, x, deterministic=False)  # no key for the stream


def test_embed_lookup():
    ids = jnp.array([[0, 3, 3], [2, 1, 0]])
    v, y = _init_apply(nn.Embed(5, 4), ids)
    table = np.asarray(v["params"]["embedding"])
    np.testing.assert_array_equal(np.asarray(y), table[np.asarray(ids)])


def test_multihead_attention_matches_numpy(rng):
    b, t, s, d, h = 2, 3, 5, 8, 2
    xq = rng.standard_normal((b, t, d)).astype(np.float32)
    xkv = rng.standard_normal((b, s, d)).astype(np.float32)
    mask = np.ones((b, 1, 1, s), bool)
    mask[1, ..., 3:] = False
    m = nn.MultiHeadAttention(num_heads=h)
    v, y = _init_apply(m, jnp.asarray(xq), jnp.asarray(xkv), mask=jnp.asarray(mask))
    p = {k: {n: np.asarray(a) for n, a in w.items()} for k, w in v["params"].items()}
    proj = lambda x, n: np.einsum("btd,dhk->bthk", x, p[n]["kernel"]) + p[n]["bias"]
    q, k, vv = proj(xq, "query"), proj(xkv, "key"), proj(xkv, "value")
    sc = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d // h)
    sc = np.where(mask, sc, -np.inf)
    w = np.exp(sc - sc.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    o = np.einsum("bhqk,bkhd->bqhd", w, vv)
    ref = np.einsum("bqhd,hdf->bqf", o, p["out"]["kernel"]) + p["out"]["bias"]
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-5)


class _Net(nn.Module):
    width: int

    def setup(self):
        self.proj = nn.Dense(self.width)

    def __call__(self, x, train: bool = False):
        h = nn.Dense(self.width)(self.proj(x))
        h = nn.Dense(self.width, name="named")(h)
        return MaskedBatchNorm()(h[:, None], jnp.ones((x.shape[0], 1), bool),
                                 use_running_average=not train)


def test_module_paths_init_and_mutability(rng):
    """Submodule names (setup attribute, auto ``Class_k``, explicit),
    deterministic init per path and seed, and the mutable-collection rule."""
    x = jnp.asarray(rng.standard_normal((4, 3)).astype(np.float32))
    net = _Net(5)
    v = net.init(jax.random.key(0), x)
    assert set(v) == {"params", "batch_stats"}
    assert set(v["params"]) == {"proj", "Dense_0", "named", "MaskedBatchNorm_0"}
    again = net.init(jax.random.key(0), x)
    for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    other = net.init(jax.random.key(1), x)
    assert not np.array_equal(np.asarray(v["params"]["proj"]["kernel"]),
                              np.asarray(other["params"]["proj"]["kernel"]))
    with pytest.raises(ValueError, match="mutable"):
        net.apply(v, x, train=True)  # batch stats would change
    y, upd = net.apply(v, x, train=True, mutable=["batch_stats"])
    assert set(upd) == {"batch_stats"} and y.shape == (4, 1, 5)
    # apply never writes into the caller's variables
    np.testing.assert_array_equal(np.asarray(v["batch_stats"]["MaskedBatchNorm_0"]["mean"]), 0.0)


def test_remat_matches_plain_with_dropout_and_stats(rng):
    """remat recomputes the block: same outputs, gradients, dropout masks
    and batch-stat updates as the plain module."""

    class Block(nn.Module):
        def __call__(self, x, deterministic):
            h = nn.Dropout(0.5)(nn.Dense(6)(x), deterministic=deterministic)
            return MaskedBatchNorm()(h, jnp.ones(x.shape[:2], bool),
                                     use_running_average=deterministic)

    class Stack(nn.Module):
        remat: bool

        def __call__(self, x, deterministic=False):
            cls = nn.remat(Block, static_argnums=(2,)) if self.remat else Block
            return cls(name="b")(x, deterministic)

    x = jnp.asarray(rng.standard_normal((2, 4, 3)).astype(np.float32))
    v = Stack(False).init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, x)

    def run(remat):
        def f(p):
            y, upd = Stack(remat).apply({**v, "params": p}, x, rngs={"dropout": jax.random.key(2)},
                                        mutable=["batch_stats"])
            return jnp.sum(y ** 2), (y, upd)
        return jax.grad(f, has_aux=True)(v["params"])

    (g0, (y0, u0)), (g1, (y1, u1)) = run(False), run(True)
    for a, b in zip(jax.tree.leaves((g0, y0, u0)), jax.tree.leaves((g1, y1, u1))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
