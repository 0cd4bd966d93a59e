"""CTC decoding: greedy argmax and vectorized fixed-width beam search.

Greedy decode reproduces the reference's ``predict`` (argmax over vocab per
frame, `lib/standard/asrnn.py:48-58`); token→string handling (drop pad/blank
for word vocab, CTC repeat-collapse for word pieces) lives in
`data/vocab.py`, mirroring `myvocab.py:211-231` / `wordpiecemodel.py:359-387`.

Beam search is a static-shape version of CTC prefix beam search
(Hannun et al. 2014): XLA needs static shapes, so the hypothesis set is a
fixed-width beam held in dense arrays, and per-step expansion considers only
the top-``prune`` tokens of the frame.  Duplicate merging exploits the
beam-uniqueness invariant — distinct beams always hold distinct prefixes, so
the only possible collision is an *extend* landing on an existing *stay*
(prefix_j + tok == prefix_i) — reducing the merge to a (beam, beam, prune)
hash match instead of an O((beam·prune)²) all-pairs matrix.  Everything is
one ``lax.scan`` over time under ``vmap`` over the batch; no host
round-trips, so sharded decode for NST pseudo-labeling runs entirely
on-device.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

NEG_INF = -1e30


def greedy_decode(
    log_probs: jnp.ndarray, frame_lengths: Optional[jnp.ndarray] = None, pad_id: int = 1
) -> jnp.ndarray:
    """Per-frame argmax; frames beyond the valid length become ``pad_id``.

    log_probs: (B, T, V) → (B, T) int32 token ids.
    """
    ids = jnp.argmax(log_probs, axis=-1).astype(jnp.int32)
    if frame_lengths is not None:
        t = log_probs.shape[1]
        mask = jnp.arange(t)[None, :] < frame_lengths[:, None]
        ids = jnp.where(mask, ids, pad_id)
    return ids


def collapse_repeats(
    ids: jnp.ndarray, blank_id: int, pad_id: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """CTC collapse on-device: drop repeats then blanks, left-pack the rest.

    ids: (B, T) → (packed (B, T) padded with pad_id, lengths (B,)).
    Matches the WPM decode semantics (`wordpiecemodel.py:375-379`).
    """
    b, t = ids.shape
    prev = jnp.concatenate([jnp.full((b, 1), -1, ids.dtype), ids[:, :-1]], axis=1)
    keep = (ids != prev) & (ids != blank_id) & (ids != pad_id)
    # left-pack via sort on (position of kept items first)
    order_key = jnp.where(keep, jnp.arange(t)[None, :], t + jnp.arange(t)[None, :])
    perm = jnp.argsort(order_key, axis=1)
    packed = jnp.take_along_axis(jnp.where(keep, ids, pad_id), perm, axis=1)
    lengths = jnp.sum(keep, axis=1)
    return packed, lengths


class BeamState(NamedTuple):
    prefixes: jnp.ndarray  # (beam, Lmax) int32
    lengths: jnp.ndarray  # (beam,) int32
    last: jnp.ndarray  # (beam,) int32, -1 if empty prefix
    p_b: jnp.ndarray  # (beam,) log prob of prefix ending in blank
    p_nb: jnp.ndarray  # (beam,) log prob of prefix ending in non-blank
    phash: jnp.ndarray  # (beam,) uint32 rolling hash of prefix


_HASH_MULT = jnp.uint32(1000003)


def _beam_step(state: BeamState, inputs, *, beam: int, prune: int):
    """Scan body over precomputed per-frame candidates.

    The V-wide top-k runs OUTSIDE the scan (one batched ``top_k`` over all
    frames — inside the scan it serializes 240 V-wide sorts and dominated
    beam cost); only beam-width work remains per frame.
    """
    logp, tok_lp, tok_ids, lp_blank, active = inputs  # (V,), (P,), (P,), (), ()
    # repeat of last token extends p_nb without changing the prefix.
    # One-hot contraction, not logp[last]: no batched gather inside the
    # scan; mirrors the sharded path.
    onehot = (state.last[:, None] == jnp.arange(logp.shape[0])[None, :]).astype(
        logp.dtype
    )
    # HIGHEST precision: a default-precision f32 matmul may round inputs
    # (TF32 on the GPU), perturbing the repeat-of-last log-prob every frame
    # (can flip beam rankings on near-ties; CPU parity tests would never see
    # it).  Same
    # contraction as ops/ctc.py's emit matmul, same precision requirement.
    lp_last = jnp.einsum(
        "bv,v->b", onehot, logp, precision=jax.lax.Precision.HIGHEST
    )
    lp_last = jnp.where(state.last >= 0, lp_last, NEG_INF)
    return _beam_step_core(
        state, tok_lp, tok_ids, lp_blank, lp_last, active, beam=beam, prune=prune
    )


def _beam_step_core(
    state: BeamState, tok_lp, tok_ids, lp_blank, lp_last, active,
    *, beam: int, prune: int,
):
    """One prefix-beam update from per-frame candidate quantities.

    ``tok_lp``/``tok_ids`` (P,): the frame's pruned non-blank candidates;
    ``lp_blank`` scalar; ``lp_last`` (beam,): log-prob of each beam's last
    token this frame (NEG_INF for empty prefixes).  Shared by the dense path
    (`_beam_step`) and the vocab-sharded TP path
    (`ctc_beam_search_sharded`), which computes these via collectives.
    """
    lmax = state.prefixes.shape[1]

    # ---- candidate generation -------------------------------------------
    # "stay" candidates: one per beam (blank emission or repeat of last).
    stay_pb = jnp.logaddexp(state.p_b, state.p_nb) + lp_blank  # (beam,)
    stay_pnb = state.p_nb + lp_last

    # "extend" candidates: beam × prune, append token c.
    c_ids = tok_ids[None, :]  # (1, P)
    c_lp = tok_lp[None, :]  # (1, P)
    same_as_last = c_ids == state.last[:, None]  # (beam, P)
    # extending with a repeated token only from the blank-ending mass;
    # a different token from the full mass.
    ext_src = jnp.where(
        same_as_last, state.p_b[:, None], jnp.logaddexp(state.p_b, state.p_nb)[:, None]
    )
    ext_pnb = ext_src + c_lp  # (beam, P)

    # ---- flatten to candidate arrays ------------------------------------
    # candidate i in [0, beam): stay; i in [beam, beam+beam*P): extend.
    # NO index gathers anywhere in this step: everything is broadcasts and
    # one-hot reductions, which XLA fuses.
    n_ext = beam * prune
    cand_pb = jnp.concatenate([stay_pb, jnp.full((n_ext,), NEG_INF)])
    cand_pnb = jnp.concatenate([stay_pnb, ext_pnb.reshape(-1)])
    # "parent beam" of each candidate, as broadcasts (stay_i→i, ext(j,p)→j)
    bcast = lambda x: jnp.broadcast_to(x[:, None], (beam, prune)).reshape(-1)
    parent = jnp.concatenate([jnp.arange(beam), bcast(jnp.arange(beam))])
    ext_tok = jnp.concatenate(
        [jnp.full((beam,), -1, jnp.int32), jnp.tile(tok_ids, beam)]
    )
    is_ext = ext_tok >= 0

    cand_len = jnp.concatenate([state.lengths, bcast(state.lengths) + 1])
    cand_last = jnp.concatenate([state.last, jnp.tile(tok_ids, beam)])
    ext_hash_all = bcast(state.phash) * _HASH_MULT + (
        jnp.tile(tok_ids, beam) + 1
    ).astype(jnp.uint32)
    cand_hash = jnp.concatenate([state.phash, ext_hash_all])
    # guard: extensions past Lmax are invalid
    overflow = is_ext & (jnp.concatenate([state.lengths, bcast(state.lengths)]) >= lmax)
    cand_pb = jnp.where(overflow, NEG_INF, cand_pb)
    cand_pnb = jnp.where(overflow, NEG_INF, cand_pnb)

    # ---- merge duplicates -------------------------------------------------
    # Beams hold DISTINCT prefixes (invariant: the init hashes are distinct
    # and this merge re-establishes uniqueness every step), so the only
    # possible collision is extend(j, tok) == stay(i), i.e. prefix_j + tok =
    # prefix_i.  That is a (beam, beam, P) match — not the O(C²) all-pairs
    # matrix — and only p_nb mass moves (extends carry no blank mass).
    ext_hash = state.phash[:, None] * _HASH_MULT + (tok_ids[None, :] + 1).astype(
        jnp.uint32
    )  # (beam, P) hash of parent j extended by token p
    ext_valid = (state.lengths[:, None] < lmax)  # (beam, 1) broadcast over P
    match = (
        (state.phash[:, None, None] == ext_hash[None, :, :])
        & (state.lengths[:, None, None] == state.lengths[None, :, None] + 1)
        & ext_valid[None, :, :]
    )  # (beam_i, beam_j, P)

    # absorb matching extends' p_nb into stay_i, then kill those extends
    ext_masked = jnp.where(match, ext_pnb[None, :, :], NEG_INF)  # (beam, beam, P)
    m = jnp.max(ext_masked, axis=(1, 2))
    m_safe = jnp.where(m <= NEG_INF / 2, 0.0, m)
    absorbed = m_safe + jnp.log(
        jnp.sum(jnp.exp(ext_masked - m_safe[:, None, None]), axis=(1, 2))
    )
    absorbed = jnp.where(m <= NEG_INF / 2, NEG_INF, absorbed)
    stay_pnb_merged = jnp.logaddexp(cand_pnb[:beam], absorbed)
    killed = jnp.any(match, axis=0).reshape(-1)  # (beam·P,)
    merged_pb = cand_pb
    merged_pnb = jnp.concatenate(
        [stay_pnb_merged, jnp.where(killed, NEG_INF, cand_pnb[beam:])]
    )

    # ---- top-beam selection ---------------------------------------------
    total = jnp.logaddexp(merged_pb, merged_pnb)
    _, top_idx = jax.lax.top_k(total, beam)

    # gather-free selection: one-hot mask over the C candidates; every
    # pick is a masked sum (exactly one nonzero per row, so exact for
    # ints/uint32 hashes — a float matmul would round 32-bit hashes)
    n_cand = beam + n_ext
    sel = top_idx[:, None] == jnp.arange(n_cand)[None, :]  # (beam, C) bool
    pick = lambda x: jnp.sum(
        jnp.where(sel, x[None, :], jnp.zeros_like(x[:1])), axis=1
    )
    sel_parent = pick(parent)
    sel_tok = pick(ext_tok)
    sel_is_ext = sel_tok >= 0
    # parent-row pick of prefixes/lengths via a (beam_new, beam_old) one-hot
    pmat = sel_parent[:, None] == jnp.arange(beam)[None, :]
    new_prefixes = jnp.sum(
        jnp.where(pmat[:, :, None], state.prefixes[None, :, :], 0), axis=1
    )
    append_pos = jnp.sum(jnp.where(pmat, state.lengths[None, :], 0), axis=1)
    one_hot = (
        jnp.arange(lmax)[None, :] == append_pos[:, None]
    ) & sel_is_ext[:, None]
    new_prefixes = jnp.where(one_hot, sel_tok[:, None], new_prefixes)

    new_state = BeamState(
        prefixes=new_prefixes,
        lengths=pick(cand_len),
        last=pick(cand_last),
        p_b=pick(merged_pb),
        p_nb=pick(merged_pnb),
        phash=pick(cand_hash),
    )
    # inactive frame (t >= length): carry state through unchanged
    new_state = jax.tree.map(
        lambda n, o: jnp.where(
            jnp.reshape(active, (1,) * n.ndim), n, o
        ),
        new_state,
        state,
    )
    return new_state, None


@partial(jax.jit, static_argnames=("blank_id", "beam", "prune", "max_label_len"))
def ctc_beam_search(
    log_probs: jnp.ndarray,
    frame_lengths: Optional[jnp.ndarray] = None,
    *,
    blank_id: int = 0,
    beam: int = 8,
    prune: int = 8,
    max_label_len: int = 128,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched CTC prefix beam search.

    Args:
        log_probs: (B, T, V) log-softmax outputs.
        frame_lengths: (B,) valid frame counts (default: all T).

    Returns:
        (tokens (B, beam, max_label_len), lengths (B, beam), scores (B, beam))
        sorted best-first.  ``tokens`` is padded with -1.
    """
    b, t, v = log_probs.shape
    prune = min(prune, v - 1)
    if frame_lengths is None:
        frame_lengths = jnp.full((b,), t, jnp.int32)

    def single(lp, n_frames):
        init = BeamState(
            prefixes=jnp.full((beam, max_label_len), -1, jnp.int32),
            lengths=jnp.zeros((beam,), jnp.int32),
            last=jnp.full((beam,), -1, jnp.int32),
            p_b=jnp.where(jnp.arange(beam) == 0, 0.0, NEG_INF),
            p_nb=jnp.full((beam,), NEG_INF),
            # distinct initial hashes so empty dummy beams don't merge with
            # the real empty prefix
            phash=jnp.arange(beam, dtype=jnp.uint32) * jnp.uint32(2654435761),
        )
        active = jnp.arange(t) < n_frames
        # one batched V-wide top-k for all frames, outside the scan
        lp_noblank = lp.at[:, blank_id].set(NEG_INF)
        tok_lp, tok_ids = jax.lax.top_k(lp_noblank, prune)  # (T, P)
        lp_blank = lp[:, blank_id]  # (T,)
        step = partial(_beam_step, beam=beam, prune=prune)
        final, _ = jax.lax.scan(step, init, (lp, tok_lp, tok_ids, lp_blank, active))
        score = jnp.logaddexp(final.p_b, final.p_nb)
        order = jnp.argsort(-score)
        return final.prefixes[order], final.lengths[order], score[order]

    return jax.vmap(single)(log_probs, frame_lengths)


def ctc_beam_search_sharded(
    lp_local: jnp.ndarray,
    frame_lengths: Optional[jnp.ndarray] = None,
    *,
    axis: str,
    blank_id: int = 0,
    beam: int = 8,
    prune: int = 8,
    max_label_len: int = 128,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Vocab-sharded CTC prefix beam search (call under ``shard_map``).

    For tensor-parallel decode the final projection is column-sharded, so
    each chip holds ``lp_local`` = its (B, T, V/mp) slice of the log-probs
    (PartitionSpec(None, None, axis)) and the full log-probs never
    materialise on one chip.  Per SURVEY.md §7 ("cross-chip hypothesis
    exchange for model-sharded decode"), the V-dependent pieces ride
    collectives over ``axis``:

      * per-frame candidates: local top-`prune` → ``all_gather`` →
        global top-`prune` (exact: the global top-P is contained in the
        union of local top-Ps);
      * blank log-prob: masked ``psum`` (exactly one shard owns blank);
      * the repeat-of-last lookup inside the scan: one-hot contraction over
        the local slice + ``psum``.

    The V-independent beam bookkeeping is replicated on every chip, so the
    returned hypotheses are identical across shards.  Returns the same
    (tokens, lengths, scores) as `ctc_beam_search`.
    """
    b, t, v_local = lp_local.shape
    mp = jax.lax.psum(1, axis)
    offset = jax.lax.axis_index(axis) * v_local
    if frame_lengths is None:
        frame_lengths = jnp.full((b,), t, jnp.int32)

    # -- per-frame candidates (precomputed for all frames) -----------------
    local_ids = offset + jnp.arange(v_local)
    is_blank = local_ids == blank_id  # (Vl,)
    lp_noblank = jnp.where(is_blank[None, None, :], NEG_INF, lp_local)
    p_local = min(prune, v_local)
    loc_lp, loc_idx = jax.lax.top_k(lp_noblank, p_local)  # (B, T, Pl)
    loc_gids = loc_idx + offset
    # gather candidates from every shard: (mp, B, T, Pl) → (B, T, mp·Pl)
    all_lp = jnp.moveaxis(jax.lax.all_gather(loc_lp, axis), 0, 2).reshape(
        b, t, mp * p_local
    )
    all_ids = jnp.moveaxis(jax.lax.all_gather(loc_gids, axis), 0, 2).reshape(
        b, t, mp * p_local
    )
    prune = min(prune, mp * p_local)
    tok_lp, sel = jax.lax.top_k(all_lp, prune)  # (B, T, P)
    tok_ids = jnp.take_along_axis(all_ids, sel, axis=2)
    # blank log-prob: owned by exactly one shard → masked psum is exact
    lp_blank = jax.lax.psum(
        jnp.sum(jnp.where(is_blank[None, None, :], lp_local, 0.0), axis=2), axis
    )  # (B, T)

    def single(lp_loc_1, tok_lp_1, tok_ids_1, lp_blank_1, n_frames):
        init = BeamState(
            prefixes=jnp.full((beam, max_label_len), -1, jnp.int32),
            lengths=jnp.zeros((beam,), jnp.int32),
            last=jnp.full((beam,), -1, jnp.int32),
            p_b=jnp.where(jnp.arange(beam) == 0, 0.0, NEG_INF),
            p_nb=jnp.full((beam,), NEG_INF),
            phash=jnp.arange(beam, dtype=jnp.uint32) * jnp.uint32(2654435761),
        )
        active = jnp.arange(t) < n_frames

        def step(state, inp):
            lp_loc_t, tlp, tid, lpb, act = inp
            # repeat-of-last lookup: one-hot over the local vocab slice,
            # reduced across shards
            onehot = (
                state.last[:, None] == local_ids[None, :]
            ).astype(lp_loc_t.dtype)  # (beam, Vl)
            # HIGHEST precision to stay bit-identical with the dense path
            # (default matmul precision may round inputs: TF32 on the GPU).
            lp_last = jax.lax.psum(
                jnp.einsum(
                    "bv,v->b",
                    onehot,
                    lp_loc_t,
                    precision=jax.lax.Precision.HIGHEST,
                ),
                axis,
            )
            lp_last = jnp.where(state.last >= 0, lp_last, NEG_INF)
            return _beam_step_core(
                state, tlp, tid, lpb, lp_last, act, beam=beam, prune=prune
            )

        final, _ = jax.lax.scan(
            step, init, (lp_loc_1, tok_lp_1, tok_ids_1, lp_blank_1, active)
        )
        score = jnp.logaddexp(final.p_b, final.p_nb)
        order = jnp.argsort(-score)
        return final.prefixes[order], final.lengths[order], score[order]

    return jax.vmap(single)(
        lp_local,
        tok_lp,
        tok_ids,
        lp_blank,
        frame_lengths,
    )
