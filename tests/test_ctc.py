"""CTC loss: parity with optax.ctc_loss and gradient sanity."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from nn_conformer_for_speech_recognition_tpu.ops.ctc import ctc_loss, ctc_loss_from_logits


def _random_case(rng, b=4, t=20, v=7, l=6):
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    labels = rng.integers(1, v, size=(b, l)).astype(np.int32)
    input_lengths = rng.integers(l * 2 + 2, t + 1, size=(b,)).astype(np.int32)
    label_lengths = rng.integers(1, l + 1, size=(b,)).astype(np.int32)
    return logits, labels, input_lengths, label_lengths


def test_matches_optax(rng):
    logits, labels, il, ll = _random_case(rng)
    b, t, v = logits.shape
    log_probs = jax.nn.log_softmax(jnp.asarray(logits))
    ours = ctc_loss(log_probs, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll),
                    blank_id=0, reduction=None)

    logit_paddings = (np.arange(t)[None] >= il[:, None]).astype(np.float32)
    label_paddings = (np.arange(labels.shape[1])[None] >= ll[:, None]).astype(np.float32)
    ref = optax.ctc_loss(jnp.asarray(logits), jnp.asarray(logit_paddings),
                         jnp.asarray(labels), jnp.asarray(label_paddings), blank_id=0)
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_nonzero_blank_id(rng):
    """Reference uses blank at a vocab-dependent index (`myvocab.py:94-99`)."""
    logits, labels, il, ll = _random_case(rng, v=8)
    labels = np.where(labels == 3, 7, labels)  # avoid blank id 3 in labels
    log_probs = jax.nn.log_softmax(jnp.asarray(logits))
    ours = ctc_loss(log_probs, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll),
                    blank_id=3, reduction=None)
    # permute vocab so blank 3 ↔ 0 and compare against optax with blank 0
    perm = np.arange(8)
    perm[[0, 3]] = perm[[3, 0]]
    logits_p = logits[..., perm]
    labels_p = np.where(labels == 0, 3, labels)
    t, l = logits.shape[1], labels.shape[1]
    ref = optax.ctc_loss(
        jnp.asarray(logits_p),
        jnp.asarray((np.arange(t)[None] >= il[:, None]).astype(np.float32)),
        jnp.asarray(labels_p),
        jnp.asarray((np.arange(l)[None] >= ll[:, None]).astype(np.float32)),
        blank_id=0,
    )
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_perfect_alignment_low_loss():
    """Peaked logits exactly matching the label → near-zero loss."""
    v, t = 5, 8
    labels = jnp.array([[1, 2, 3]], dtype=jnp.int32)
    path = [1, 0, 2, 0, 3, 0, 0, 0]  # valid alignment with blanks
    logits = np.full((1, t, v), -20.0, np.float32)
    for i, c in enumerate(path):
        logits[0, i, c] = 20.0
    loss = ctc_loss_from_logits(
        jnp.asarray(logits), labels, jnp.array([t]), jnp.array([3]), blank_id=0,
        reduction=None,
    )
    assert float(loss[0]) < 1e-3


def test_impossible_alignment_zeroed():
    """Label longer than input frames → zero_infinity semantics
    (`runner.py:35`)."""
    rng = np.random.default_rng(0)
    logits = jnp.asarray(rng.standard_normal((1, 3, 5)).astype(np.float32))
    labels = jnp.array([[1, 2, 3, 4]], dtype=jnp.int32)
    loss = ctc_loss_from_logits(
        logits, labels, jnp.array([3]), jnp.array([4]), reduction=None
    )
    assert float(loss[0]) == 0.0
    loss2 = ctc_loss_from_logits(
        logits, labels, jnp.array([3]), jnp.array([4]), reduction=None,
        zero_infinity=False,
    )
    assert float(loss2[0]) > 1e20


def test_gradients_finite(rng):
    logits, labels, il, ll = _random_case(rng)

    def f(lg):
        return ctc_loss_from_logits(
            lg, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll), reduction="mean"
        )

    g = jax.grad(f)(jnp.asarray(logits))
    assert np.isfinite(np.asarray(g)).all()
    # grads vanish on padded frames
    for i in range(len(il)):
        np.testing.assert_allclose(np.asarray(g)[i, il[i]:], 0.0, atol=1e-7)


def test_grad_matches_optax(rng):
    logits, labels, il, ll = _random_case(rng, b=2, t=12, v=5, l=3)
    t, l = logits.shape[1], labels.shape[1]

    def ours(lg):
        return ctc_loss_from_logits(
            lg, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll), reduction="sum"
        )

    def theirs(lg):
        return jnp.sum(optax.ctc_loss(
            lg,
            jnp.asarray((np.arange(t)[None] >= il[:, None]).astype(np.float32)),
            jnp.asarray(labels),
            jnp.asarray((np.arange(l)[None] >= ll[:, None]).astype(np.float32)),
        ))

    g1 = jax.grad(ours)(jnp.asarray(logits))
    g2 = jax.grad(theirs)(jnp.asarray(logits))
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-3, atol=1e-4)


def _optax_ref(logits, labels, il, ll, blank_id=0):
    t, l = logits.shape[1], labels.shape[1]
    return optax.ctc_loss(
        logits,
        jnp.asarray((np.arange(t)[None] >= np.asarray(il)[:, None]).astype(np.float32)),
        jnp.asarray(labels),
        jnp.asarray((np.arange(l)[None] >= np.asarray(ll)[:, None]).astype(np.float32)),
        blank_id=blank_id,
    )


def _case(rng, name):
    if name == "long_labels":  # L close to T/2: many alignment states
        b, t, v, l = 3, 64, 9, 30
        il, ll = np.array([64, 64, 61]), np.array([30, 28, 25])
    elif name == "repeated_labels":  # repeats force blanks between them
        b, t, v, l = 2, 24, 5, 8
        labels = np.array([[1, 1, 2, 2, 2, 3, 3, 1], [4, 4, 4, 4, 1, 1, 0, 0]])
        logits = rng.standard_normal((b, t, v)).astype(np.float32)
        return logits, labels.astype(np.int32), np.array([24, 20]), np.array([8, 6])
    elif name == "ragged":  # input and label lengths differ per row
        b, t, v, l = 5, 40, 11, 10
        il, ll = np.array([40, 33, 21, 12, 40]), np.array([10, 7, 9, 1, 3])
    else:  # "real_width": the Conformer-M training shapes
        b, t, v, l = 2, 235, 1024, 100
        il, ll = np.array([235, 190]), np.array([100, 80])
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    labels = rng.integers(1, v, size=(b, l)).astype(np.int32)
    return logits, labels, il, ll


@pytest.mark.parametrize("name", ["long_labels", "repeated_labels", "ragged", "real_width"])
def test_scan_loss_and_grad_match_optax(rng, name):
    """The lax.scan CTC against optax.ctc_loss: per-sequence losses and
    gradients with respect to the logits."""
    logits, labels, il, ll = _case(rng, name)
    lg = jnp.asarray(logits)

    def ours(x):
        return ctc_loss_from_logits(x, jnp.asarray(labels), jnp.asarray(il),
                                    jnp.asarray(ll), reduction=None)

    loss = ours(lg)
    ref = _optax_ref(lg, labels, il, ll)
    np.testing.assert_allclose(np.asarray(loss), np.asarray(ref), rtol=1e-4, atol=1e-3)
    g = jax.grad(lambda x: jnp.sum(ours(x)))(lg)
    g_ref = jax.grad(lambda x: jnp.sum(_optax_ref(x, labels, il, ll)))(lg)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-3, atol=1e-4)
