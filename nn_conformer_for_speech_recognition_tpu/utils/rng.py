"""Dropout PRNG implementation: XLA's RngBitGenerator ('rbg') or threefry.

JAX's default threefry PRNG computes every random bit with a counter-based
hash (about twenty integer operations per 32-bit word).  A dropout-regularised
Conformer step draws a mask for every activation, so the bits are a real part
of the step.  JAX's 'rbg' implementation keys `jax.random`'s samplers off
XLA's RngBitGenerator instead, while key split/fold_in still goes through
threefry on the (tiny) key itself, so the per-module path folding of
``make_rng('dropout')`` (`models/layers.py`) works unchanged.  One conversion
of the per-step dropout key at the ``model.apply(rngs=...)`` boundary
switches every Dropout in the model.

Trade-offs (why this is for dropout and not for initialization): rbg bit
streams are not bit-stable across XLA backends or sharding choices.  Dropout
masks need neither property.  Parameter init and data sampling keep threefry.

'auto' takes the platform's route (`backend.routes`): rbg on the GPU,
threefry on the CPU, where it is cheap and keeps the tests bit-identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nn_conformer_for_speech_recognition_tpu.backend import routes

VALID_IMPLS = ("auto", "rbg", "threefry")


def resolve_dropout_rng_impl(impl: str = "auto") -> str:
    """'rbg' or 'threefry'; 'auto' picks the platform's route."""
    if impl not in VALID_IMPLS:
        raise ValueError(
            f"dropout rng impl must be one of {VALID_IMPLS}, got {impl!r}"
        )
    if impl == "auto":
        return routes().dropout_rng
    return impl


def dropout_key(key: jax.Array, impl: str = "auto") -> jax.Array:
    """Convert a (threefry) PRNG key to the resolved dropout implementation.

    The conversion re-keys an 'rbg' generator from the threefry key's raw
    data (2 words tiled to rbg's 4-word key), so distinct step keys yield
    distinct streams.  With impl resolved to 'threefry' the key passes
    through untouched.
    """
    resolved = resolve_dropout_rng_impl(impl)
    if resolved == "threefry":
        return key
    data = jax.random.key_data(key)
    return jax.random.wrap_key_data(
        jnp.tile(data, 2)[..., :4], impl="rbg"
    )
