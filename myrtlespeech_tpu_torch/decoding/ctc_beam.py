"""Batched CTC prefix beam search on the logits' device.

Port of ``myrtlespeech_tpu/decoding/ctc_beam.py`` (prefix beam search,
Hannun 2014 / Graves 2012, with per-prefix ``(p_blank, p_non_blank)``, beam
width, probability pruning, a word-count bonus, a char-bigram LM and a word
LM).  The JAX package vmaps one utterance over the batch inside a
``lax.scan`` over frames; here the whole beam of every utterance lives in
``(B, W, ...)`` tensors and one host loop walks the frames.  The loop reads
nothing back from the device: frames past an utterance's end keep its beam
by ``torch.where``.

Each frame forms the ``W`` stay candidates and the ``W * K`` extensions
(``K = expand_topk`` best non-blank symbols, or all ``V``), merges the only
possible duplicates (a stay equal to an extension) by a pairwise match of
rolling prefix-hash pairs, and keeps the best ``W``.  What keeps the port's
tokens equal to the JAX package's:

- **Ties.** ``jax.lax.top_k`` takes the lower index among equal values and
  ``torch.topk`` does not, so the top ``K`` symbols and the top ``W``
  candidates come from a stable descending sort.
- **uint32 hashes.** The prefix and word hashes wrap at 2**32.  They live
  in ``int64`` tensors, masked to 32 bits after every multiply and add (the
  products stay under 2**57).
- **-1e30, not -inf.** Dead slots hold ``NEG_INF = -1e30`` and tie there,
  as in JAX; sums with it stay finite.
- **The prune threshold in float32**: ``log(float32(prune_threshold))``,
  as JAX takes it.
- ``expand_topk < V`` ranks symbols by their log-prob alone and is lossy
  (ROADMAP.md Queue 3); the port computes what JAX computes.

Everything that depends on the log-probs alone (the top ``K`` symbols, the
prune mask, the blank's log-prob) is computed for all frames before the
loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from myrtlespeech_tpu_torch.decoding.lm import (WORD_LM_PROBES, WORD_MUL1,
                                                WORD_MUL2, WORD_SEED1,
                                                WORD_SEED2, WordLM)

NEG_INF = -1e30
_MASK = 0xFFFFFFFF
_SEED1, _SEED2 = int(WORD_SEED1), int(WORD_SEED2)


def _hash(h: torch.Tensor, mul: torch.Tensor, c: torch.Tensor):
    """``(h * mul + c) mod 2**32``, uint32 arithmetic on int64 tensors."""
    return (h * mul + c) & _MASK


def bigram_keys(p1, p2, h1, h2):
    """``decoding/lm.py::bigram_keys`` on ``int64`` tensors of uint32
    values: the (previous word, word) table key pair."""
    return (((p1 * int(WORD_MUL1)) & _MASK) ^ h1,
            ((p2 * int(WORD_MUL2)) & _MASK) ^ h2)


@dataclasses.dataclass(frozen=True)
class WordLMTensors:
    """A :class:`~myrtlespeech_tpu_torch.decoding.lm.WordLM` as tensors on
    one device: the uint32 keys as ``int64``, the log-probs as float32, the
    scalars as the float32 values JAX scores with."""

    key1: torch.Tensor
    key2: torch.Tensor
    logp: torch.Tensor
    oov: float
    bkey1: Optional[torch.Tensor] = None
    bkey2: Optional[torch.Tensor] = None
    blogp: Optional[torch.Tensor] = None
    backoff: float = 0.0

    @classmethod
    def from_word_lm(cls, lm: WordLM) -> "WordLMTensors":
        """The tables on the CPU; :meth:`to` places them."""
        def keys(a):
            return torch.as_tensor(a.astype("int64"))

        def logp(a):
            return torch.as_tensor(a.astype("float32"))

        def f32(x):
            return float(torch.tensor(x, dtype=torch.float32))

        extra = {}
        if lm.bkey1 is not None:
            extra = dict(bkey1=keys(lm.bkey1), bkey2=keys(lm.bkey2),
                         blogp=logp(lm.blogp), backoff=f32(lm.backoff_log))
        return cls(key1=keys(lm.key1), key2=keys(lm.key2),
                   logp=logp(lm.logp), oov=f32(lm.oov_log_prob), **extra)

    def to(self, device) -> "WordLMTensors":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _word_lm_lookup(key1, key2, logp, oov: float, h1, h2, probes):
    """Probe the open-addressed table for hash pairs ``(h1, h2)`` (any
    shape): all ``WORD_LM_PROBES`` probes at once, the first hit scoring,
    as JAX's sequence of probes scores.  Misses score ``oov``.  Returns
    ``(scores, found)``."""
    S = key1.shape[0]
    # The build-time perturbation of the (0, 0) pair, the empty-slot marker.
    h1 = torch.where((h1 == 0) & (h2 == 0), 1, h1)
    step = h2 | 1
    idx = (h1[..., None] + probes * step[..., None]) & (S - 1)
    hit = (key1[idx] == h1[..., None]) & (key2[idx] == h2[..., None])
    first = hit & (hit.cumsum(-1) == 1)
    found = hit.any(-1)
    score = torch.where(first, logp[idx], 0.0).sum(-1)
    return torch.where(found, score, oov), found


def _word_lm_score(wl: WordLMTensors, wp1, wp2, wh1, wh2, probes):
    """Score the completed word (hashes ``wh``) in context ``wp``: ``log
    p(word)``, or with a bigram table ``log p(word | prev)`` on a hit, else
    ``backoff + log p(word)`` (stupid backoff)."""
    uni, _ = _word_lm_lookup(wl.key1, wl.key2, wl.logp, wl.oov, wh1, wh2,
                             probes)
    if wl.bkey1 is None:
        return uni
    bk1, bk2 = bigram_keys(wp1, wp2, wh1, wh2)
    big, hit = _word_lm_lookup(wl.bkey1, wl.bkey2, wl.blogp, 0.0, bk1, bk2,
                               probes)
    return torch.where(hit, big, wl.backoff + uni)


def prune_log_threshold(prune_threshold: float) -> float:
    """``log(float32(prune_threshold))`` in float32, on the host (so the
    card and the CPU prune alike), or ``NEG_INF`` for 0, as JAX takes it;
    log-probs at or above it are extended."""
    if prune_threshold <= 0:
        return NEG_INF
    return float(torch.log(torch.tensor(prune_threshold,
                                        dtype=torch.float32)))


# Columns of the beam's integer state, ``(B, W, 8)`` int64: the prefix hash
# pair, the current word's hash pair, the previous completed word's hash
# pair (bigram context), the prefix length and its last symbol (-1 if
# empty).  JAX reads the last symbol from the prefix buffer each frame; the
# two agree on every live beam.
_H, _WH, _WP, _LEN, _LAST = slice(0, 2), slice(2, 4), slice(4, 6), 6, 7


def ctc_beam_decode(logits: torch.Tensor, logit_lens: torch.Tensor, *,
                    blank_index: int = 0, beam_width: int = 16,
                    prune_threshold: float = 1e-3,
                    word_count_beta: Optional[float] = None,
                    separator_index: Optional[int] = None,
                    lm_alpha: Optional[float] = None,
                    lm_bigram: Optional[torch.Tensor] = None,
                    word_lm_alpha: Optional[float] = None,
                    word_lm=None,
                    max_output_len: Optional[int] = None,
                    expand_topk: Optional[int] = None):
    """Prefix-beam-search decode a batch of ``(B, T, V)`` logits.

    ``lm_bigram``: optional ``(V+1, V)`` char-bigram log-prob matrix (row
    ``V`` = sentence start) scored with weight ``lm_alpha``.  ``word_lm``:
    optional :class:`~myrtlespeech_tpu_torch.decoding.lm.WordLM` (or
    :class:`WordLMTensors`); each word completed by a ``separator_index``
    emission scores ``word_lm_alpha * log p_lm(word)``, and so does the
    final unterminated word.  Requires ``separator_index``.

    Returns ``(tokens (B, U) int32, token_lens (B,) int32)`` for the best
    prefix of each utterance, ``U = max_output_len or T``, on the logits'
    device.
    """
    B, T, V = logits.shape
    U = max_output_len or T
    W = beam_width
    blank, sep = blank_index, separator_index
    if word_lm is not None and sep is None:
        raise ValueError("word_lm scoring requires separator_index")
    dev = logits.device
    logp = torch.log_softmax(logits.float(), -1).transpose(0, 1)  # (T,B,V)
    prune_log = prune_log_threshold(prune_threshold)
    wl = None
    if word_lm is not None:
        wl = (word_lm if isinstance(word_lm, WordLMTensors)
              else WordLMTensors.from_word_lm(word_lm)).to(dev)
    score_words = wl is not None and word_lm_alpha is not None
    completes_on = sep is not None and (word_count_beta is not None
                                        or wl is not None)
    char_lm = None
    if lm_alpha is not None and lm_bigram is not None:
        char_lm = torch.as_tensor(lm_bigram, dtype=torch.float32,
                                  device=dev)

    # Per frame, from the log-probs alone: the K symbols a beam may extend
    # by, their log-probs and which pass the blank and prune masks.
    if expand_topk is not None and expand_topk < V:
        K = expand_topk
        top = logp.clone()
        top[..., blank] = NEG_INF
        lp_top, sym = top.sort(dim=-1, descending=True, stable=True)
        lp_top, sym = lp_top[..., :K], sym[..., :K]
    else:
        K = V
        lp_top = logp
        sym = torch.arange(V, device=dev).expand(T, B, V)
    ext_ok = (sym != blank) & (lp_top >= prune_log)
    sym_sep = sym == sep if completes_on else None
    sym_code = sym + 1  # what a symbol adds to a rolling hash
    valid = (torch.arange(T, device=dev)[:, None]
             < logit_lens.to(dev)[None, :])[:, :, None]  # (T, B, 1)
    mul = torch.tensor([int(WORD_MUL1), int(WORD_MUL2)], device=dev)
    probes = torch.arange(WORD_LM_PROBES, device=dev)
    seeds = torch.tensor([_SEED1, _SEED2], device=dev)

    # The initial beam: one empty prefix (p_b = 0), the rest dead.
    prefixes = torch.zeros((B, W, U + 1), dtype=torch.int64, device=dev)
    st = torch.zeros((B, W, 8), dtype=torch.int64, device=dev)
    st[..., _WH] = seeds
    st[..., _WP] = seeds
    st[..., _LAST] = -1
    prob = torch.full((B, W, 2), NEG_INF, device=dev)  # p_b, p_nb
    prob[:, 0, 0] = 0.0

    for t in range(T):
        lp = logp[t]
        h, ln, last = st[..., _H], st[..., _LEN], st[..., _LAST]
        p_b, p_nb = prob[..., 0], prob[..., 1]
        total = torch.logaddexp(p_b, p_nb)  # (B, W)

        # Stay candidates: blank keeps the prefix, and so does its last
        # symbol repeated (it collapses).  Dead beams' candidates die.
        alive = total > NEG_INF / 2
        stay_pb = torch.where(alive, total + lp[:, blank, None], NEG_INF)
        stay_pnb = torch.where(alive & (last >= 0),
                               p_nb + lp.gather(1, last.clamp(min=0)),
                               NEG_INF)

        # Extensions (B, W, K): prefix + c; the double-letter rule takes
        # p_b alone when c repeats the last symbol.
        s = sym[t][:, None, :]
        ext_base = torch.where(last[..., None] == s, p_b[..., None],
                               total[..., None])
        ext_p = torch.where(ext_ok[t][:, None, :],
                            ext_base + lp_top[t][:, None, :], NEG_INF)
        if completes_on:
            # A separator extension completes the beam's current word.
            completes = sym_sep[t][:, None, :] \
                & ((last != sep) & (ln > 0))[..., None]
            if word_count_beta is not None:
                ext_p = torch.where(completes, ext_p + word_count_beta,
                                    ext_p)
            if score_words:
                wlp = _word_lm_score(wl, st[..., 4], st[..., 5],
                                     st[..., 2], st[..., 3], probes)
                ext_p = torch.where(
                    completes, ext_p + word_lm_alpha * wlp[..., None], ext_p)
        if char_lm is not None:
            row = torch.where(last >= 0, last, V)
            ext_p = ext_p + lm_alpha * char_lm[row[..., None], s]

        # Kill the extensions of dead beams and overlong ones.
        e_pnb = torch.where((alive & (ln < U))[..., None], ext_p,
                            NEG_INF).reshape(B, W * K)

        # Merge: the only live duplicates are a stay equal to an extension
        # (each live stay matches at most one live extension), found by the
        # prefix-hash pairs.  With at most one live match the max is the
        # logsumexp JAX takes, bit for bit: the dead matches are -1e30.
        eh = _hash(h[:, :, None, :], mul, sym_code[t][:, None, :, None])
        alive_stay = torch.logaddexp(stay_pb, stay_pnb) > NEG_INF / 2
        match = (h[:, :, None, :] == eh.reshape(B, 1, W * K, 2)).all(-1) \
            & alive_stay[..., None]  # (B, W, W*K)
        into_stay = torch.where(match, e_pnb[:, None, :], NEG_INF).amax(-1)
        m_pnb = torch.cat([torch.logaddexp(stay_pnb, into_stay),
                           torch.where(match.any(1), NEG_INF, e_pnb)], 1)
        # An extension's p_b is -1e30, so its score is its p_nb exactly.
        score = torch.cat([torch.logaddexp(stay_pb, m_pnb[:, :W]),
                           m_pnb[:, W:]], 1)

        # The best W of the W + W*K candidates, ties to the lower index.
        top_idx = score.sort(dim=-1, descending=True,
                             stable=True).indices[:, :W]
        is_ext = top_idx >= W
        e = (top_idx - W).clamp(min=0)
        src = torch.where(is_ext, e // K, top_idx)
        sel = sym[t].gather(1, e % K)  # the symbol, if an extension
        ch = torch.where(is_ext, sel, -1)
        new_prob = torch.stack([
            torch.where(is_ext, NEG_INF, stay_pb.gather(1, src)),
            m_pnb.gather(1, top_idx)], -1)

        par = st.gather(1, src[..., None].expand(B, W, 8))
        ext, code = is_ext[..., None], (sel + 1)[..., None]
        words = par[..., _WH.start:_LEN]
        if wl is not None:
            # The current word's hashes (reset by a separator) and the
            # previous completed word's (a separator that completes a
            # non-empty word promotes the current word to the context).
            is_sep = is_ext & (ch == sep)
            done = is_sep & (par[..., _LAST] != sep) & (par[..., _LEN] > 0)
            words = torch.cat([
                torch.where(ext, torch.where(is_sep[..., None], seeds,
                                             _hash(par[..., _WH], mul,
                                                   code)),
                            par[..., _WH]),
                torch.where(done[..., None], par[..., _WH], par[..., _WP])],
                -1)
        new = torch.cat([
            torch.where(ext, _hash(par[..., _H], mul, code), par[..., _H]),
            words, (par[..., _LEN] + is_ext)[..., None],
            torch.where(is_ext, ch, par[..., _LAST])[..., None]], -1)

        # The prefix buffer: append the symbol; stays and overlong
        # extensions write to the spare last column (JAX drops them).
        pre = prefixes.gather(1, src[..., None].expand(B, W, U + 1))
        pos = torch.where(is_ext, par[..., _LEN].clamp(max=U), U)
        pre.scatter_(2, pos[..., None], sel[..., None])

        # Frames past the utterance's end keep the beam.
        v = valid[t]
        prefixes = torch.where(v[..., None], pre, prefixes)
        st = torch.where(v[..., None], new, st)
        prob = torch.where(v[..., None], new_prob, prob)

    score = torch.logaddexp(prob[..., 0], prob[..., 1])
    if score_words:
        # The final unterminated word: beams whose word hashes are not the
        # empty seeds carry one.
        wh = st[..., _WH]
        has_word = (wh != seeds).any(-1)
        wlp = _word_lm_score(wl, st[..., 4], st[..., 5], wh[..., 0],
                             wh[..., 1], probes)
        score = torch.where(has_word, score + word_lm_alpha * wlp, score)
    best = score.argmax(1)  # the first maximum, as JAX's
    rows = torch.arange(B, device=dev)
    return (prefixes[rows, best, :U].to(torch.int32),
            st[rows, best, _LEN].to(torch.int32))
