"""Gather-free Transformer-XL relative shift (and its adjoint).

Maps a relative-distance table ``x[..., i, l]`` with ``l = (j - i) + (T-1)``
to absolute coordinates ``y[..., i, j]`` using only pad/reshape/slice — the
classic "rel shift" trick, with no batched ``take_along_axis`` gather.

Verified element-exact against the gather formulation (tests/test_models.py,
tests/test_attention.py).
"""

from __future__ import annotations

import jax.numpy as jnp


def rel_shift(x: jnp.ndarray) -> jnp.ndarray:
    """(..., T, 2T-1) → (..., T, T): y[..., i, j] = x[..., i, j - i + T - 1]."""
    *lead, t, l = x.shape
    assert l == 2 * t - 1, (t, l)
    pad = [(0, 0)] * len(lead) + [(0, 0), (1, 0)]
    p = jnp.pad(x, pad)  # (..., T, 2T)
    q = p.reshape(*lead, 2 * t, t)[..., 1:, :]  # (..., 2T-1, T)
    return q.reshape(*lead, t, 2 * t - 1)[..., :t]


def rel_shift_adjoint(ds: jnp.ndarray) -> jnp.ndarray:
    """(..., T, T) → (..., T, 2T-1): exact adjoint (re-binning) of rel_shift.

    z[..., i, l] = ds[..., i, l - (T-1) + i] where in range, else 0 — the
    cotangent scatter needed in attention backward passes.
    """
    *lead, t, t2 = ds.shape
    assert t2 == t, (t, t2)
    y = jnp.pad(ds, [(0, 0)] * len(lead) + [(0, 0), (0, t - 1)])  # (..., T, 2T-1)
    q = y.reshape(*lead, 2 * t - 1, t)
    q = jnp.pad(q, [(0, 0)] * len(lead) + [(1, 0), (0, 0)])  # (..., 2T, T)
    return q.reshape(*lead, t, 2 * t)[..., 1:]
