"""LSTM recurrence over packed weights, one direction at a time.

Each direction owns ``w_ih`` (D, 4H), ``w_hh`` (H, 4H) and ``bias`` (4H,),
gates in (i, f, g, o) order — torch.nn.LSTM's layout, transposed, and the
layout of the reference's BiLSTM head (`lib/hparams.py:78-81`).  The input
projection is hoisted into one matmul; the recurrence is a ``lax.scan``
with the carry held at zero on padded steps.  On padded steps (t >= length)
the output is zero, and the reverse direction starts at each sequence's own
last valid step.  The tests hold it to ``jax.experimental.rnn.lstm_ref``.

cuDNN's fused RNN (``jax.experimental.rnn.lstm``, the kernel behind the
reference's ``nn.LSTM`` on CUDA) was measured against this scan on an H100
and lost the pseudo-label pass, so it is not used (PERF.md).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Weights = Tuple[jax.Array, jax.Array, jax.Array]  # (w_ih, w_hh, bias)


def lstm_scan(
    x: jax.Array,
    weights: Weights,
    lengths: jax.Array,
    reverse: bool = False,
    dtype=jnp.float32,
) -> jax.Array:
    """(B, T, D) → (B, T, H) for one direction.  Matmuls take ``dtype``
    operands with float32 accumulation; the carry stays float32."""
    w_ih, w_hh, bias = weights
    xw = jnp.matmul(x.astype(dtype), w_ih.astype(dtype),
                    preferred_element_type=jnp.float32) + bias
    w = w_hh.astype(dtype)
    b, t, _ = x.shape
    hid = w_hh.shape[0]
    valid = jnp.arange(t)[:, None] < lengths[None, :]  # (T, B)

    def step(carry, inp):
        h, c = carry
        xw_t, ok = inp
        g = xw_t + jnp.matmul(h.astype(dtype), w, preferred_element_type=jnp.float32)
        i, f, gg, o = jnp.split(g, 4, axis=-1)
        c_new = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(gg)
        h_new = jax.nn.sigmoid(o) * jnp.tanh(c_new)
        ok = ok[:, None]
        return (jnp.where(ok, h_new, h), jnp.where(ok, c_new, c)), jnp.where(ok, h_new, 0.0)

    zeros = jnp.zeros((b, hid), jnp.float32)
    _, ys = jax.lax.scan(step, (zeros, zeros), (jnp.swapaxes(xw, 0, 1), valid),
                         reverse=reverse)
    return jnp.swapaxes(ys, 0, 1)
