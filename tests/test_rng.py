"""Dropout RNG impl selection (utils/rng.py).

The GPU train path converts the per-step dropout key to the 'rbg'
(XLA RngBitGenerator) implementation.  On CPU 'auto' must stay threefry so
these tests (and all CPU numerics) are bit-identical to threefry dropout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nn_conformer_for_speech_recognition_tpu.models import layers as nn
from nn_conformer_for_speech_recognition_tpu.utils.rng import (
    dropout_key,
    resolve_dropout_rng_impl,
)


def test_auto_resolves_threefry_on_cpu():
    assert resolve_dropout_rng_impl("auto") == "threefry"


def test_invalid_impl_raises():
    with pytest.raises(ValueError):
        resolve_dropout_rng_impl("pallsa")


def test_threefry_passthrough_is_identity():
    k = jax.random.key(7)
    out = dropout_key(k, impl="threefry")
    assert out is k  # not just equal: the very same key, zero overhead


def test_auto_on_cpu_is_identity():
    k = jax.random.key(7)
    assert dropout_key(k) is k


def test_rbg_key_is_rbg_impl_and_usable():
    k = jax.random.key(7)
    rk = dropout_key(k, impl="rbg")
    assert str(jax.random.key_impl(rk)) != str(jax.random.key_impl(k))
    # as models/layers.py does: fold per module path, then draw a mask
    folded = jax.random.fold_in(rk, 42)
    mask = jax.random.bernoulli(folded, 0.9, (8, 128))
    frac = float(jnp.mean(mask.astype(jnp.float32)))
    assert 0.7 < frac < 1.0


def test_distinct_step_keys_give_distinct_rbg_streams():
    k1, k2 = jax.random.split(jax.random.key(0))
    m1 = jax.random.bernoulli(dropout_key(k1, impl="rbg"), 0.5, (4, 256))
    m2 = jax.random.bernoulli(dropout_key(k2, impl="rbg"), 0.5, (4, 256))
    assert not np.array_equal(np.asarray(m1), np.asarray(m2))


def test_rbg_key_drives_flax_dropout_under_jit():
    """The exact product pattern: converted key into model.apply rngs."""

    class M(nn.Module):
        def __call__(self, x, deterministic):
            x = nn.Dense(16)(x)
            return nn.Dropout(0.5)(x, deterministic=deterministic)

    m = M()
    x = jnp.ones((4, 8))
    params = m.init({"params": jax.random.key(0)}, x, True)

    @jax.jit
    def apply(p, key):
        return m.apply(p, x, False, rngs={"dropout": dropout_key(key, impl="rbg")})

    y1 = apply(params, jax.random.key(1))
    y2 = apply(params, jax.random.key(2))
    assert y1.shape == (4, 16)
    assert np.isfinite(np.asarray(y1)).all()
    assert not np.array_equal(np.asarray(y1), np.asarray(y2))
    # roughly half the activations dropped
    frac_zero = float(jnp.mean((y1 == 0).astype(jnp.float32)))
    assert 0.2 < frac_zero < 0.8


def test_rbg_dropout_under_device_mesh():
    """The multi-device path: rbg keys inside a GSPMD-sharded step.

    XLA's RngBitGenerator must partition (or legally replicate) under
    jit — run a dropout model with a batch-sharded input over a mesh and
    require a finite, correctly-shaped result.  (The full DP x TP train
    step with rbg forced is exercised by __graft_entry__.dryrun_multichip;
    this is the minimal in-suite pin.)
    """
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    class M(nn.Module):
        def __call__(self, x, deterministic):
            x = nn.Dense(32)(x)
            return nn.Dropout(0.3)(x, deterministic=deterministic)

    devices = np.array(jax.devices()[:4]).reshape(4)
    mesh = Mesh(devices, ("data",))
    m = M()
    x = jnp.ones((8, 16))
    params = m.init({"params": jax.random.key(0)}, x, True)
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))

    @jax.jit
    def apply(p, xb, key):
        return m.apply(p, xb, False, rngs={"dropout": dropout_key(key, impl="rbg")})

    y = apply(params, xs, jax.random.key(3))
    assert y.shape == (8, 32)
    assert np.isfinite(np.asarray(y)).all()
    frac_zero = float(jnp.mean((y == 0).astype(jnp.float32)))
    assert 0.05 < frac_zero < 0.6
