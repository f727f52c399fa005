"""Batched RNN-T beam search (port of ``decoding/rnnt_beam.py``).

Graves 2012 Algorithm 1 over fixed-size tensors: per encoder frame the
hypotheses expand in up to ``max_symbols_per_step`` rounds, in each of which
every live hypothesis either takes **blank** (joining the frame's *finished*
set) or **emits** a symbol (staying in the *expanding* set, its prediction
net advanced).  Identical label sequences reached by different paths are
merged by a log-sum-exp keyed on a rolling pair of 32-bit prefix hashes, and
both sets are cut to the beam width every round.  ``length_norm`` divides the
final scores by the sequence length.

The JAX package vmaps one utterance over the batch, with a ``lax.while_loop``
over frame blocks and another over expansion rounds.  Here every
utterance's beam lives in ``(B, W, ...)`` tensors (the prediction-net state
in rows ``b * W + w``) and each data-dependent loop is a host loop that
reads one flag from the device an iteration: ``any(t < n_valid)`` per block
step (or frame) and the expansion condition per round.  A row whose own
condition is false keeps its carry through ``torch.where``, as a vmapped
``while_loop`` or ``cond`` keeps it, so every row's result is its own
utterance's.  :data:`LOOP_COUNTS` counts the host iterations and the flags
read; CUDA graphs for the loop bodies are later work.

What keeps the port's tokens equal to the JAX package's:

- **Ties.** ``jax.lax.top_k`` takes the lower index among equal values and
  ``torch.topk`` does not, so every top-k is a stable descending sort;
  ``argmax`` takes the first maximum in both.
- **uint32 hashes** live in ``int64`` tensors, masked to 32 bits after each
  multiply-add (the products stay under 2**57).
- **-1e30, not -inf.** Dead slots hold ``NEG_INF = -1e30`` and tie there;
  sums with it stay finite.
- **Sequential sums.** XLA's ``cumsum`` on the CPU adds in order in float32;
  ``torch.cumsum`` on the CPU accumulates in float64, so the speculative
  block's running blank sums are added one frame at a time.

The JAX module's ``_merge_topk`` (an argsort and segmented-scan merge) is
called nowhere in the JAX package, so it is not copied.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import torch

from myrtlespeech_tpu_torch.decoding.rnnt_greedy import _select, tree_map

NEG_INF = -1e30
_MASK = 0xFFFFFFFF
_MUL1 = 0x01000193
_MUL2 = 0x00100001

# Host iterations of the decoder's loops since the counts were last zeroed:
# ``calls``, ``block_steps`` (speculative path), ``frames`` (frame-by-frame
# path), ``rounds`` (expansion rounds past the hoisted round 0) and
# ``flag_reads`` (booleans copied from the device to steer a loop).
LOOP_COUNTS: collections.Counter = collections.Counter()

# Columns of the integer part of a beam, ``(B, W, 3)`` int64: the sequence
# length and the prefix hash pair.
_LEN, _H = 0, slice(1, 3)


def _top(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: ties to the lower index."""
    v, i = x.sort(dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


class _Beam:
    """One set of ``W`` hypotheses for each of ``B`` utterances."""

    __slots__ = ("tokens", "ints", "score", "g", "state")

    def __init__(self, tokens, ints, score, g, state):
        self.tokens = tokens  # (B, W, U + 1) int64; column U takes drops
        self.ints = ints      # (B, W, 3) int64: length, hash 1, hash 2
        self.score = score    # (B, W) float32
        self.g = g            # (B, W, H_pred) prediction-net output
        self.state = state    # prediction-net state, rows b * W + w

    def fields(self):
        return (self.tokens, self.ints, self.score, self.g, self.state)

    def where(self, m: torch.Tensor, old: "_Beam") -> "_Beam":
        return _Beam(*_select(m, self.fields(), old.fields()))


def _exclusive_sums(x: torch.Tensor) -> torch.Tensor:
    """``[0, x0, x0 + x1, ...]`` along dim 1, ``(B, F + 1, ...)`` from
    ``(B, F, ...)``: added one step at a time in ``x``'s dtype, the order
    of XLA's ``cumsum`` on the CPU (``torch.cumsum`` there accumulates in
    float64)."""
    sums = [torch.zeros_like(x[:, 0])]
    for i in range(x.shape[1]):
        sums.append(sums[-1] + x[:, i])
    return torch.stack(sums, 1)


def _state_rows(state, idx: torch.Tensor):
    """Rows ``idx`` (flat) of every state tensor."""
    return tree_map(lambda a: a.index_select(0, idx), state)


def _merge_two_sets_topk(a_sc, a_h1, a_h2, b_sc, b_h1, b_h2, W: int):
    """Merge set ``b`` into set ``a`` where hashes match, then top ``W``.

    Inputs ``(..., W)``.  The live rows of each set are duplicate-free (each
    is a merged top W), so the only live duplicates are cross-pairs, found
    by one ``(W, W)`` equality test.  A dead ``a`` row keeps its stale hash
    and must not absorb a live ``b``, so the match is masked by ``a``'s
    liveness.  A live ``a`` matches at most one live ``b`` and every dead
    score is ``-1e30``, so the largest match is the log-sum-exp JAX takes,
    bit for bit.  Returns ``(scores (..., W), selector (..., W))`` indexing
    ``concat(a, b)``.
    """
    match = (a_h1[..., :, None] == b_h1[..., None, :]) \
        & (a_h2[..., :, None] == b_h2[..., None, :]) \
        & (a_sc > NEG_INF / 2)[..., :, None]  # (..., Wa, Wb)
    add = torch.where(match, b_sc[..., None, :], NEG_INF).amax(-1)
    a_merged = torch.logaddexp(a_sc, add)
    b_left = torch.where(match.any(-2), NEG_INF, b_sc)
    return _top(torch.cat([a_merged, b_left], -1), W)


def rnnt_beam_decode(
    f: torch.Tensor,  # (B, T, H_enc) encoder output (or its joint projection)
    f_lens: torch.Tensor,  # (B,)
    predict_step: Callable,  # (tokens (N,), state) -> (g (N, H), state)
    joint_step: Callable,  # (f_t (N, H_enc), g (N, H)) -> (N, V) logits
    init_state,  # prediction-net state for N = B * beam_width rows
    *,
    blank_index: int,
    beam_width: int = 8,
    length_norm: bool = False,
    max_symbols_per_step: int = 30,
    max_output_len: int = 200,
    expand_topk: Optional[int] = None,
    prune_expands: bool = True,
    speculative_frames: Optional[int] = 8,
    tally: Optional[dict] = None,
):
    """Beam-search decode a batch.  Returns ``(tokens (B, U) int32, lens
    (B,) int32)`` on ``f``'s device, ``U = max_output_len``.

    ``expand_topk``: extend each hypothesis by only its k most probable
    non-blank symbols (None = all V).  ``speculative_frames`` F: one joint
    evaluates F frames against the beam's prediction-net outputs, the
    leading run of *pure-blank* frames (no symbol extension can beat the
    worst blank move) is consumed by score adds, and the expansion runs at
    the first emitting frame; output-identical to the frame-by-frame loop
    under ``prune_expands``.  Requires ``prune_expands``; None or 1 takes
    the frame-by-frame loop.

    ``tally``, if given, receives device counts over the batch:
    ``valid_frames``, ``pure_blank_frames`` (consumed by score adds),
    ``expanded_frames`` and ``row_rounds`` (rounds that expanded frames ran,
    round 0 included).
    """
    W = beam_width
    B, T, _ = f.shape
    U = max_output_len
    F = speculative_frames if prune_expands else None
    if F is not None and F <= 1:
        F = None
    dev = f.device
    n_valid = f_lens.to(device=dev, dtype=torch.int64)
    rows = torch.arange(B, device=dev)
    mul = torch.tensor([_MUL1, _MUL2], device=dev)
    no_cutoff = torch.full((B,), NEG_INF / 2, device=dev)
    blank_masks = {}  # V -> (V,) bool, true at the blank
    LOOP_COUNTS["calls"] += 1
    if tally is not None:
        for k in ("pure_blank_frames", "expanded_frames", "row_rounds"):
            tally[k] = torch.zeros((), dtype=torch.int64, device=dev)
        tally["valid_frames"] = n_valid.clamp(0, T).sum()

    def joint_logp(f_rows, g_rows):
        """log_softmax of the joint, float32, ``(N, V)``."""
        return torch.log_softmax(joint_step(f_rows, g_rows).float(), -1)

    def blank_mask(V: int) -> torch.Tensor:
        if V not in blank_masks:
            blank_masks[V] = torch.arange(V, device=dev) == blank_index
        return blank_masks[V]

    def emit_extensions(r: int, exp: _Beam, logp: torch.Tensor) -> _Beam:
        """W x K symbol extensions of ``exp``, cut to the best W."""
        V = logp.shape[-1]
        if expand_topk is not None and expand_topk < V:
            K = expand_topk
            # Blank masked so that the top k are non-blank symbols.
            lp_nb = torch.where(blank_mask(V), NEG_INF, logp)
            lp_top, char_mat = _top(lp_nb, K)  # (B, W, K)
            ext_sc = exp.score[..., None] + lp_top
        else:
            K = V
            ext_sc = exp.score[..., None] + logp  # (B, W, V)
            char_mat = torch.arange(V, device=dev).expand(B, W, V)
        lens = exp.ints[..., _LEN]
        ok = (char_mat != blank_index) & (lens[..., None] < U) \
            & (r < max_symbols_per_step)
        ext_sc = torch.where(ok, ext_sc, NEG_INF).reshape(B, W * K)
        # The expanding set holds distinct sequences, and so do their
        # one-symbol extensions: a plain top W, no merge.
        e_sc, e_sel = _top(ext_sc, W)
        p_sel = torch.div(e_sel, K, rounding_mode="floor")
        c_sel = char_mat.reshape(B, W * K).gather(1, e_sel)
        par = exp.ints.gather(1, p_sel[..., None].expand(B, W, 3))
        code = (c_sel + 1)[..., None]
        live = e_sc > NEG_INF / 2
        ints = torch.cat([(par[..., :1] + live[..., None]),
                          (par[..., _H] * mul + code) & _MASK], -1)
        tokens = exp.tokens.gather(1, p_sel[..., None].expand(B, W, U + 1))
        pos = torch.where(live, par[..., _LEN], U)
        sym = c_sel.clamp(min=0)
        tokens.scatter_(2, pos[..., None], sym[..., None])
        # Advance the prediction net for the emitted hypotheses.
        flat = (rows[:, None] * W + p_sel).reshape(-1)
        g, state = predict_step(sym.reshape(-1),
                                _state_rows(exp.state, flat))
        return _Beam(tokens, ints, e_sc, g.reshape(B, W, -1), state)

    def expand_frame(f_t: torch.Tensor, beam: _Beam, lp0: torch.Tensor,
                     live: torch.Tensor) -> _Beam:
        """The blank/emit rounds of one frame for the rows ``live (B,)``
        (others' results are discarded by the caller).  ``lp0 (B, W, V)``
        is the frame's round-0 joint log-softmax for the carried beam.
        Round 0 is hoisted: its finished pool is the beam with the blank's
        score, with nothing to merge."""
        f_rows = f_t[:, None, :].expand(B, W, f_t.shape[-1]).reshape(
            B * W, -1)
        fin = _Beam(beam.tokens, beam.ints,
                    beam.score + lp0[..., blank_index], beam.g, beam.state)
        exp = emit_extensions(0, beam, lp0)
        running = live
        r = 1
        while True:
            # One round past the emission cap applies only the blank move
            # (emissions masked): the reference's forced blank.  Graves'
            # prune: extensions only lower a score, so once the best
            # expanding hypothesis is below the W-th finished score, no
            # descendant can enter the beam.
            if r > max_symbols_per_step:
                break
            cutoff = (fin.score.amin(-1).clamp(min=NEG_INF / 2)
                      if prune_expands else no_cutoff)
            running = running & (exp.score > cutoff[:, None]).any(-1)
            LOOP_COUNTS["flag_reads"] += 1
            if not bool(running.any()):
                break
            LOOP_COUNTS["rounds"] += 1
            if tally is not None:
                tally["row_rounds"] += running.sum()
            logp = joint_logp(f_rows, exp.g.reshape(B * W, -1)).reshape(
                B, W, -1)
            # Blank: the expanding hypotheses join the finished pool.
            blank_sc = exp.score + logp[..., blank_index]
            top_sc, sel = _merge_two_sets_topk(
                fin.score, fin.ints[..., 1], fin.ints[..., 2],
                blank_sc, exp.ints[..., 1], exp.ints[..., 2], W)
            flat = (rows[:, None] * (2 * W) + sel).reshape(-1)

            def pick(a, b):
                both = torch.cat([a.reshape(B, W, -1), b.reshape(B, W, -1)],
                                 1).reshape(B * 2 * W, -1)
                return both.index_select(0, flat).reshape(a.shape)

            new_fin = _Beam(pick(fin.tokens, exp.tokens),
                            pick(fin.ints, exp.ints), top_sc,
                            pick(fin.g, exp.g),
                            tree_map(pick, fin.state, exp.state))
            exp = emit_extensions(r, exp, logp)
            fin = new_fin.where(running, fin)
            r += 1
        # The loop ends once every expanding hypothesis is dead (blank
        # taken, forced in the last round), so the finished pool is the
        # new beam.
        return fin

    # The initial beam: one empty hypothesis, the rest dead.
    g0, state = predict_step(
        torch.full((B * W,), -1, dtype=torch.int64, device=dev), init_state)
    score = torch.full((B, W), NEG_INF, device=dev)
    score[:, 0] = 0.0
    beam = _Beam(torch.zeros((B, W, U + 1), dtype=torch.int64, device=dev),
                 torch.zeros((B, W, 3), dtype=torch.int64, device=dev),
                 score, g0.reshape(B, W, -1), state)

    if F is None:
        LOOP_COUNTS["flag_reads"] += 1
        frames = min(T, int(n_valid.max()))
        for t in range(frames):
            LOOP_COUNTS["frames"] += 1
            f_t = f[:, t]
            lp0 = joint_logp(
                f_t[:, None, :].expand(B, W, f.shape[-1]).reshape(B * W, -1),
                beam.g.reshape(B * W, -1)).reshape(B, W, -1)
            valid = t < n_valid
            if tally is not None:
                tally["expanded_frames"] += valid.sum()
                tally["row_rounds"] += valid.sum()
            beam = expand_frame(f_t, beam, lp0, valid).where(valid, beam)
    else:
        # Padded so that the F-frame window never runs off the end.
        f_pad = torch.nn.functional.pad(f, (0, 0, 0, F))
        ar = torch.arange(F, device=dev)
        t = torch.zeros((B,), dtype=torch.int64, device=dev)
        while True:
            active = t < n_valid
            LOOP_COUNTS["flag_reads"] += 1
            if not bool(active.any()):
                break
            LOOP_COUNTS["block_steps"] += 1
            tc = t.clamp(max=T)  # rows past their end: any in-range window
            f_blk = f_pad[rows[:, None], tc[:, None] + ar]  # (B, F, H)
            H_f = f_blk.shape[-1]
            lp_blk = joint_logp(
                f_blk[:, :, None, :].expand(B, F, W, H_f).reshape(-1, H_f),
                beam.g[:, None].expand(B, F, W, beam.g.shape[-1]).reshape(
                    B * F * W, -1)).reshape(B, F, W, -1)
            # Blank moves leave g untouched, so lp_blk at the emitting frame
            # is also its round-0 joint.  Every frame's pure-blank test runs
            # at once on the running blank sums.
            frame_valid = (tc[:, None] + ar) < n_valid[:, None]  # (B, F)
            blank_lp = lp_blk[..., blank_index]  # (B, F, W)
            nbmax = torch.where(blank_mask(lp_blk.shape[-1]), NEG_INF,
                                lp_blk).amax(-1)
            step_add = torch.where(frame_valid[..., None], blank_lp, 0.0)
            csum_excl = _exclusive_sums(step_add)  # (B, F + 1, W)
            sc_i = beam.score[:, None, :] + csum_excl[:, :F]
            pure = (sc_i + nbmax).amax(-1) <= (sc_i + blank_lp).amin(-1)
            stop = frame_valid & ~pure
            hit = stop.any(-1)
            k = torch.where(hit, stop.to(torch.int32).argmax(-1), F)
            consumed = _Beam(beam.tokens, beam.ints,
                             beam.score + csum_excl[rows, k], beam.g,
                             beam.state)
            live = active & hit
            if tally is not None:
                tally["pure_blank_frames"] += torch.where(
                    active, torch.minimum(k, n_valid - t), 0).sum()
                tally["expanded_frames"] += live.sum()
                tally["row_rounds"] += live.sum()
            f_t = f_pad[rows, (tc + k).clamp(max=T + F - 1)]
            lp0 = lp_blk[rows, k.clamp(max=F - 1)]  # (B, W, V)
            new = expand_frame(f_t, consumed, lp0, live)
            beam = new.where(live, consumed).where(active, beam)
            t = torch.where(active, t + k + hit, t)

    final = beam.score
    lens = beam.ints[..., _LEN]
    if length_norm:
        final = final / lens.clamp(min=1).to(final.dtype)
    best = final.argmax(-1)  # the first maximum, as JAX's
    return (beam.tokens[rows, best, :U].to(torch.int32),
            lens[rows, best].to(torch.int32))
