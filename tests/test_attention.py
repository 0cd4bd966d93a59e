"""Relative-position self-attention (models/conformer.RelPositionMHSA): the
einsum + pad/reshape rel-shift path against a plain gather reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nn_conformer_for_speech_recognition_tpu.models.conformer import (
    RelPositionMHSA,
    length_mask,
    sinusoidal_rel_positions,
)

D, H = 16, 2


def gather_relpos_mhsa(p, x, mask, num_heads):
    """The module's function written directly: LayerNorm → qkv → scores
    (q+u)·k + (q+v)·r[j-i], the relative term looked up by gather → masked
    softmax → values → out_proj."""
    b, t, d = x.shape
    dh = d // num_heads
    ln = p["LayerNorm_0"]
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    xn = (x - mean) * jax.lax.rsqrt(var + 1e-6) * ln["scale"] + ln["bias"]
    q, k, v = jnp.split(xn @ p["qkv"]["kernel"], 3, axis=-1)
    q, k, v = (a.reshape(b, t, num_heads, dh) for a in (q, k, v))
    r = (jnp.asarray(sinusoidal_rel_positions(t, d)) @ p["pos_proj"]["kernel"]).reshape(
        2 * t - 1, num_heads, dh)
    ac = jnp.einsum("bihd,bjhd->bhij", q + p["u_bias"], k)
    bd_full = jnp.einsum("bihd,lhd->bhil", q + p["v_bias"], r)
    idx = (jnp.arange(t)[None, :] - jnp.arange(t)[:, None]) + (t - 1)  # l = j - i + T-1
    bd = jnp.take_along_axis(bd_full, jnp.broadcast_to(idx, bd_full.shape[:2] + (t, t)), -1)
    scores = jnp.where(mask[:, None, None, :], (ac + bd) / np.sqrt(dh), -1e30)
    out = jnp.einsum("bhij,bjhd->bihd", jax.nn.softmax(scores, -1), v).reshape(b, t, d)
    return out @ p["out_proj"]["kernel"] + p["out_proj"]["bias"]


def _case(rng, t, b=2):
    x = jnp.asarray(rng.standard_normal((b, t, D)).astype(np.float32))
    lens = jnp.asarray(np.maximum(t - 3 * t // 4 * np.arange(b), 1).astype(np.int32))
    mask = length_mask(lens, t)
    m = RelPositionMHSA(D, H, dropout=0.0)
    params = m.init(jax.random.key(0), x, mask, True)["params"]
    # non-zero content/position biases (they initialise at zero)
    params = {**params,
              "u_bias": jnp.asarray(rng.standard_normal((H, D // H)).astype(np.float32)),
              "v_bias": jnp.asarray(rng.standard_normal((H, D // H)).astype(np.float32))}
    return m, params, x, mask


@pytest.mark.parametrize("t", [5, 64, 600])
def test_relpos_attention_matches_gather_reference(rng, t):
    m, params, x, mask = _case(rng, t)
    with jax.default_matmul_precision("highest"):
        got = jax.jit(lambda p, x: m.apply({"params": p}, x, mask, True))(params, x)
        ref = gather_relpos_mhsa(params, x, mask, H)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_relpos_attention_gradients_match_gather_reference(rng):
    m, params, x, mask = _case(rng, 24)
    cot = jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))
    valid = mask[..., None]

    def loss(f):
        return lambda p, x: jnp.sum(jnp.where(valid, f(p, x), 0.0) * cot)

    with jax.default_matmul_precision("highest"):
        g = jax.grad(loss(lambda p, x: m.apply({"params": p}, x, mask, True)),
                     argnums=(0, 1))(params, x)
        g_ref = jax.grad(loss(lambda p, x: gather_relpos_mhsa(p, x, mask, H)),
                         argnums=(0, 1))(params, x)
    for a, r in zip(jax.tree.leaves(g), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r), atol=1e-4, rtol=1e-4)
