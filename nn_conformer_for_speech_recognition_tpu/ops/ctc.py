"""CTC loss — log-space forward (alpha) recursion under ``lax.scan``.

Replacement for the reference's ``torch.nn.CTCLoss(blank=blank_idx,
zero_infinity=True)`` (`lib/standard/runner.py:35,143`).  The recursion is a
single ``lax.scan`` over time with fully static shapes: labels are padded to a
fixed max length, the extended (blank-interleaved) sequence has static length
2L+1, and per-example input/label lengths enter only through masks — no
data-dependent control flow, so the whole loss jits and differentiates
(backward = autodiff through the scan).

``zero_infinity`` semantics are reproduced: when a target is longer than the
input permits (no valid alignment), the loss is zeroed instead of inf
(`runner.py:35`), replacing the reference's downstream NaN→100 metric hack
(`runner.py:166`) with a well-defined value.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

LOG_EPS = -1e30  # effectively log(0) without producing nan gradients


def _logaddexp3(a, b, c):
    m = jnp.maximum(jnp.maximum(a, b), c)
    m_safe = jnp.where(m <= LOG_EPS, 0.0, m)
    # subtracting m_safe keeps exps ≤ 1; clamping the sum away from 0 keeps
    # log (and its gradient) finite when every operand is log(0)
    s = jnp.exp(a - m_safe) + jnp.exp(b - m_safe) + jnp.exp(c - m_safe)
    out = m_safe + jnp.log(jnp.maximum(s, 1e-37))
    return jnp.where(m <= LOG_EPS, LOG_EPS, out)


def extended_labels(labels: jnp.ndarray, label_lengths: jnp.ndarray, blank_id: int):
    """Blank-interleaved CTC label machinery of the scan loss.

    Returns (ext (B,S), can_skip (B,S) bool, valid_pos (B,S) bool,
    ext_len (B,)) with S = 2L+1.
    """
    b, l = labels.shape
    s = 2 * l + 1
    ext = jnp.full((b, s), blank_id, dtype=labels.dtype)
    ext = ext.at[:, 1::2].set(labels)
    # Can alpha skip from s-2? Only for non-blank positions whose label
    # differs from the label two back.
    prev2 = jnp.concatenate(
        [jnp.full((b, 2), -1, dtype=ext.dtype), ext[:, :-2]], axis=1
    )
    is_label_pos = (jnp.arange(s)[None, :] % 2) == 1
    can_skip = is_label_pos & (ext != prev2)
    ext_len = 2 * label_lengths + 1
    valid_pos = jnp.arange(s)[None, :] < ext_len[:, None]
    return ext, can_skip, valid_pos, ext_len


def emit_log_probs(log_probs: jnp.ndarray, ext: jnp.ndarray) -> jnp.ndarray:
    """emit[b, t, s] = log_probs[b, t, ext[b, s]] — as a one-hot matmul.

    A one-hot contraction instead of a (B, T, S) advanced-indexing gather:
    one matmul, whose adjoint is another matmul instead of a scatter.  HIGHEST precision keeps the selection exact
    (default-precision bf16 passes round the selected log-probs to ~2⁻⁸).
    """
    onehot = (
        ext[:, :, None] == jnp.arange(log_probs.shape[2])[None, None, :]
    ).astype(log_probs.dtype)
    return jnp.einsum(
        "btv,bsv->bts", log_probs, onehot, precision=jax.lax.Precision.HIGHEST
    )


def apply_reduction(
    nll: jnp.ndarray,
    ll: jnp.ndarray,
    label_lengths: jnp.ndarray,
    zero_infinity: bool,
    reduction: Optional[str],
) -> jnp.ndarray:
    """torch-CTCLoss reduction + ``zero_infinity`` semantics (runner.py:35)."""
    if zero_infinity:
        # impossible alignment (e.g. label too long for input) → 0, matching
        # torch's zero_infinity=True.
        impossible = ll <= LOG_EPS / 2
        nll = jnp.where(impossible, 0.0, nll)
    if reduction is None or reduction == "none":
        return nll
    if reduction == "sum":
        return jnp.sum(nll)
    if reduction == "mean":
        # torch CTCLoss 'mean': per-seq loss / target_length, then batch mean.
        denom = jnp.maximum(label_lengths, 1).astype(nll.dtype)
        return jnp.mean(nll / denom)
    raise ValueError(f"unknown reduction {reduction!r}")


def ctc_loss(
    log_probs: jnp.ndarray,
    labels: jnp.ndarray,
    input_lengths: jnp.ndarray,
    label_lengths: jnp.ndarray,
    blank_id: int = 0,
    zero_infinity: bool = True,
    reduction: Optional[str] = "mean",
) -> jnp.ndarray:
    """Connectionist Temporal Classification loss.

    Args:
        log_probs: (B, T, V) log-softmax outputs.
        labels: (B, L) int32 target ids (padded arbitrarily beyond length).
        input_lengths: (B,) valid frame counts.
        label_lengths: (B,) valid label counts.
        blank_id: index of the CTC blank (reference: `<blank>` at
            vocab position per `myvocab.py:94-99`).
        reduction: 'mean' (torch CTCLoss default: sum over batch of
            per-sequence loss / label_length, then mean), 'sum', or None.

    Returns:
        scalar (reduced) or (B,) per-sequence negative log-likelihood.
    """
    b, t, v = log_probs.shape
    l = labels.shape[1]
    s = 2 * l + 1

    # Extended label sequence z: blank, y1, blank, y2, ..., blank. (B, S)
    ext, can_skip, valid_pos, ext_len = extended_labels(
        labels, label_lengths, blank_id
    )

    # emit once for all (t, s) as one matmul (no per-step gathers in the scan)
    emit_all = emit_log_probs(log_probs, ext)  # (B, T, S)

    # alpha_0
    alpha0 = jnp.where(jnp.arange(s)[None, :] < 2, emit_all[:, 0], LOG_EPS)
    alpha0 = jnp.where(valid_pos, alpha0, LOG_EPS)

    def step(alpha, emit_t):
        emit, t_idx = emit_t
        shift1 = jnp.concatenate([jnp.full((b, 1), LOG_EPS), alpha[:, :-1]], axis=1)
        shift2 = jnp.concatenate([jnp.full((b, 2), LOG_EPS), alpha[:, :-2]], axis=1)
        shift2 = jnp.where(can_skip, shift2, LOG_EPS)
        new = _logaddexp3(alpha, shift1, shift2) + emit
        new = jnp.where(valid_pos, new, LOG_EPS)
        # frames at/after input_length leave alpha unchanged
        active = (t_idx < input_lengths)[:, None]
        new = jnp.where(active, new, alpha)
        return new, None

    emits = jnp.moveaxis(emit_all[:, 1:, :], 1, 0)  # (T-1, B, S)
    t_ids = jnp.arange(1, t)
    alpha_final, _ = jax.lax.scan(step, alpha0, (emits, t_ids))

    # NLL = -logsumexp(alpha[2L], alpha[2L-1]) at the final extended positions.
    idx_last = (ext_len - 1)[:, None]
    idx_prev = jnp.maximum(ext_len - 2, 0)[:, None]
    a_last = jnp.take_along_axis(alpha_final, idx_last, axis=1)[:, 0]
    a_prev = jnp.take_along_axis(alpha_final, idx_prev, axis=1)[:, 0]
    # degenerate empty label (len 0): only the single blank position counts
    a_prev = jnp.where(ext_len[...] >= 2, a_prev, LOG_EPS)
    ll = jnp.logaddexp(a_last, a_prev)
    return apply_reduction(-ll, ll, label_lengths, zero_infinity, reduction)


def ctc_loss_from_logits(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    input_lengths: jnp.ndarray,
    label_lengths: jnp.ndarray,
    blank_id: int = 0,
    **kw,
) -> jnp.ndarray:
    """Convenience wrapper applying log_softmax first."""
    return ctc_loss(
        jax.nn.log_softmax(logits, axis=-1),
        labels,
        input_lengths,
        label_lengths,
        blank_id=blank_id,
        **kw,
    )
