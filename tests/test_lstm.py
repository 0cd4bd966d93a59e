"""ops/lstm.py: the packed-weight scan against JAX's LSTM reference
(``jax.experimental.rnn.lstm_ref``: torch.nn.LSTM semantics, the function
cuDNN computes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import rnn

from nn_conformer_for_speech_recognition_tpu.ops.lstm import lstm_scan


def _weights(rng, d, h, n_dirs):
    mk = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32) * 0.3)
    return [(mk(d, 4 * h), mk(h, 4 * h), mk(4 * h)) for _ in range(n_dirs)]


def _ref(x, dirs, lens):
    """lstm_ref with our (w_ih, w_hh, bias) → torch layout (b_hh = 0)."""
    h = dirs[0][1].shape[0]
    n = len(dirs)
    w_ih = {i: w.T for i, (w, _, _) in enumerate(dirs)}
    w_hh = {i: w.T for i, (_, w, _) in enumerate(dirs)}
    b_ih = {i: b for i, (_, _, b) in enumerate(dirs)}
    b_hh = {i: jnp.zeros_like(b) for i, (_, _, b) in enumerate(dirs)}
    h0 = jnp.zeros((n, x.shape[0], h))
    y, _, _ = rnn.lstm_ref(x, h0, h0, w_ih, w_hh, b_ih, b_hh, lens,
                           x.shape[-1], h, 1, 0.0, n == 2)
    return y


def _ours(x, dirs, lens):
    outs = [lstm_scan(x, w, lens, reverse=i == 1) for i, w in enumerate(dirs)]
    return jnp.concatenate(outs, -1)


CASES = {
    # name: (batch, T, input, hidden, directions, ragged)
    "forward": (3, 9, 5, 4, 1, False),
    "bidirectional": (3, 9, 5, 4, 2, False),
    "ragged_bidirectional": (4, 11, 5, 4, 2, True),
    "conformer_m_decoder": (2, 235, 256, 320, 2, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_matches_lstm_ref(rng, case):
    b, t, d, h, n, ragged = CASES[case]
    x = jnp.asarray(rng.standard_normal((b, t, d)).astype(np.float32))
    dirs = _weights(rng, d, h, n)
    lens = np.full((b,), t, np.int32)
    if ragged:
        lens = np.maximum(t - 3 * np.arange(b), 1).astype(np.int32)
    lens = jnp.asarray(lens)
    with jax.default_matmul_precision("highest"):
        got, ref = jax.jit(_ours)(x, dirs, lens), _ref(x, dirs, lens)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-5)
    # padded steps are zero in both
    pad = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    assert np.all(np.asarray(got)[pad] == 0)


def test_scan_gradients_match_lstm_ref(rng):
    b, t, d, h = 3, 8, 4, 3
    x = jnp.asarray(rng.standard_normal((b, t, d)).astype(np.float32))
    dirs = _weights(rng, d, h, 2)
    lens = jnp.array([8, 5, 2], jnp.int32)
    cot = jnp.asarray(rng.standard_normal((b, t, 2 * h)).astype(np.float32))

    def loss(f):
        return lambda x, dirs: jnp.sum(f(x, dirs, lens) * cot)

    with jax.default_matmul_precision("highest"):
        g_ours = jax.grad(loss(_ours), argnums=(0, 1))(x, dirs)
        g_ref = jax.grad(loss(_ref), argnums=(0, 1))(x, dirs)
    for a, r in zip(jax.tree.leaves(g_ours), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r), atol=1e-5)


def test_scan_bf16_operands_track_f32(rng):
    """The bf16 model route: bf16 matmul operands, f32 carry."""
    x = jnp.asarray(rng.standard_normal((2, 30, 8)).astype(np.float32))
    (w,) = _weights(rng, 8, 6, 1)
    lens = jnp.array([30, 17], jnp.int32)
    f32 = lstm_scan(x, w, lens)
    bf16 = lstm_scan(x, w, lens, dtype=jnp.bfloat16)
    assert bf16.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(bf16), np.asarray(f32), atol=3e-2)
