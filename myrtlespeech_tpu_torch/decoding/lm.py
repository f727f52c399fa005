"""Character-bigram and word language models for CTC prefix beam search.

The port's copy of ``myrtlespeech_tpu/decoding/lm.py`` (numpy only): it
estimates, saves and loads the LM tables that ``decoding/ctc_beam.py``
scores inside its frame loop, in the same file formats, so that a table
either package saves loads in the other.

- A **char-bigram** LM is a dense ``(V+1, V)`` log-probability matrix
  ``lm[prev, next]`` (row ``V`` = sentence start), scored with one gather a
  frame.
- A **word** LM scores the *completed word* when a separator is emitted
  (Hannun 2014 eq. 2 applies ``p_lm`` per word).  It is an open-addressed
  hash table in flat arrays, ``(key1, key2, logp)`` rows probed with double
  hashing, so the beam search scores a completed word with a few gathers
  on the device.  Words are keyed by the same rolling FNV-style hashes over
  alphabet indices that the beam keeps for each prefix, so the in-loop word
  hash and the table key agree by construction.  Optionally a second table
  holds word bigrams, with stupid backoff to the unigrams.

The hashes are uint32 and wrap at 2**32 (numpy here; ``int64`` tensors
masked to 32 bits in the beam search).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional

import numpy as np

from myrtlespeech_tpu_torch.data.alphabet import Alphabet

#: Row index used for the sentence-start context (no previous character).
START = -1

# Rolling-hash constants shared with decoding/ctc_beam.py's word hashes.
WORD_MUL1 = np.uint32(0x01000193)
WORD_MUL2 = np.uint32(0x00100001)
WORD_SEED1 = np.uint32(2166136261)
WORD_SEED2 = np.uint32(0x9E3779B9)
#: Fixed double-hashing probe count (a constant of the beam search).
WORD_LM_PROBES = 4


def word_hashes(indices: Iterable[int]) -> tuple[np.uint32, np.uint32]:
    """Rolling hash pair of a word given as alphabet indices.

    Must match the in-loop recurrence in ``ctc_beam._beam_step``:
    ``h = h * MUL + (index + 1)`` starting from the seeds.
    """
    h1, h2 = WORD_SEED1, WORD_SEED2
    with np.errstate(over="ignore"):  # uint32 wraparound is the hash
        for c in indices:
            cu = np.uint32(int(c) + 1)
            h1 = np.uint32(h1 * WORD_MUL1 + cu)
            h2 = np.uint32(h2 * WORD_MUL2 + cu)
    return h1, h2


@dataclass(frozen=True)
class WordLM:
    """Open-addressed word LM tables for on-device lookup.

    ``key1/key2/logp`` have power-of-two length ``S``; empty slots hold
    ``key1 == key2 == 0``.  Probe ``j`` of hash pair ``(h1, h2)`` is
    ``(h1 + j * (h2 | 1)) & (S - 1)``; every stored word is reachable
    within :data:`WORD_LM_PROBES` probes (enforced at build time).
    ``oov_log_prob`` scores words not in the table.

    Optionally **bigram** (reference ``ctc_beam_decoder.proto`` n-gram LM
    semantics, SURVEY §2.1 [M]): ``bkey1/bkey2/blogp`` is a second table
    keyed on :func:`bigram_keys` of (previous word, word) hash pairs
    holding ``log p(word | prev)``; misses back off to
    ``backoff_log + log p(word)`` (stupid backoff).  The beam search
    carries the previous completed word's hash pair, so the lookup stays
    a handful of gathers inside the frame loop.
    """

    key1: np.ndarray
    key2: np.ndarray
    logp: np.ndarray
    oov_log_prob: float
    bkey1: Optional[np.ndarray] = None
    bkey2: Optional[np.ndarray] = None
    blogp: Optional[np.ndarray] = None
    backoff_log: float = 0.0


def bigram_keys(p1, p2, h1, h2):
    """Mix (prev-word, word) hash pairs into one table key pair.

    Works on numpy uint32 scalars (build time); ``ctc_beam.py`` computes
    the same on ``int64`` tensors masked to 32 bits.  Multiply-by-odd-
    constant is a bijection mod 2**32 so the pair (prev, cur) stays well
    spread; the sentence-start context is the rolling-hash seed pair (no
    real word hashes to it).
    """
    return (p1 * WORD_MUL1 ^ h1, p2 * WORD_MUL2 ^ h2)


def estimate_word_lm(transcripts: Iterable[str], alphabet: Alphabet, *,
                     separator: str = " ", smoothing: float = 1.0,
                     oov_log_prob: Optional[float] = None,
                     order: int = 1,
                     backoff: float = 0.4) -> WordLM:
    """Estimate a word :class:`WordLM` from transcripts.

    Splits on ``separator``, maps words to alphabet indices (words with
    out-of-alphabet characters are skipped), and builds the device hash
    table of add-``smoothing`` unigram log-probs.  ``oov_log_prob``
    defaults to the log-prob of an unseen word under the smoothed model.

    ``order=2`` additionally estimates a bigram table of
    ``log(c(prev, w) / c(prev))`` (MLE) with stupid-backoff weight
    ``backoff`` to the unigram table on unseen contexts; the first word
    of each transcript conditions on the sentence-start context.
    """
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    counts: Dict[tuple, float] = {}
    bi_counts: Dict[tuple, float] = {}
    ctx_counts: Dict[tuple, float] = {}
    start = ()  # sentence-start context sentinel
    total = 0
    for line in transcripts:
        prev = start
        for word in line.split(separator):
            if not word or any(ch not in alphabet for ch in word):
                prev = start  # broken context
                continue
            key = tuple(alphabet.get_indices(word))
            counts[key] = counts.get(key, 0.0) + 1.0
            total += 1
            if order == 2:
                bi_counts[(prev, key)] = bi_counts.get((prev, key), 0.) + 1.
                ctx_counts[prev] = ctx_counts.get(prev, 0.0) + 1.0
            prev = key
    n_types = max(len(counts), 1)
    denom = total + smoothing * (n_types + 1)  # +1: the OOV "type"
    if oov_log_prob is None:
        oov_log_prob = float(np.log(smoothing / denom))
    entries = [(word_hashes(k), np.log((c + smoothing) / denom))
               for k, c in counts.items()]
    uni = _build_table(entries, oov_log_prob)
    if order == 1:
        return uni

    def _ctx_hashes(k):
        return ((WORD_SEED1, WORD_SEED2) if k == start else word_hashes(k))

    with np.errstate(over="ignore"):  # uint32 wraparound is the hash
        bi_entries = [
            (bigram_keys(*_ctx_hashes(p), *word_hashes(w)),
             np.log(c / ctx_counts[p]))
            for (p, w), c in bi_counts.items()]
    bi = _build_table(bi_entries, oov_log_prob)
    return WordLM(key1=uni.key1, key2=uni.key2, logp=uni.logp,
                  oov_log_prob=uni.oov_log_prob,
                  bkey1=bi.key1, bkey2=bi.key2, blogp=bi.logp,
                  backoff_log=float(np.log(backoff)))


def _build_table(entries, oov_log_prob: float) -> WordLM:
    """Place (hash-pair, logp) entries with <= WORD_LM_PROBES probes."""
    S = 8
    while S < 4 * max(len(entries), 1):
        S *= 2
    while True:
        key1 = np.zeros((S,), np.uint32)
        key2 = np.zeros((S,), np.uint32)
        logp = np.zeros((S,), np.float32)
        ok = True
        for (h1, h2), lp in entries:
            if h1 == 0 and h2 == 0:
                h1 = np.uint32(1)  # never collide with the empty marker
            step = np.uint32(h2 | 1)
            for j in range(WORD_LM_PROBES):
                with np.errstate(over="ignore"):  # uint32 probe wraps
                    idx = int((h1 + np.uint32(j) * step)
                              & np.uint32(S - 1))
                if key1[idx] == h1 and key2[idx] == h2:
                    break  # duplicate hash pair: keep first
                if key1[idx] == 0 and key2[idx] == 0:
                    key1[idx], key2[idx], logp[idx] = h1, h2, lp
                    break
            else:
                ok = False
                break
        if ok:
            return WordLM(key1=key1, key2=key2, logp=logp,
                          oov_log_prob=float(oov_log_prob))
        S *= 2


def save_word_lm(path: str, lm: WordLM) -> None:
    """Save a :class:`WordLM` (.npz), including bigram tables if any."""
    extra = {}
    if lm.bkey1 is not None:
        extra = dict(bkey1=lm.bkey1, bkey2=lm.bkey2, blogp=lm.blogp,
                     backoff_log=np.float32(lm.backoff_log))
    np.savez(path, key1=lm.key1, key2=lm.key2, logp=lm.logp,
             oov_log_prob=np.float32(lm.oov_log_prob), **extra)


def load_word_lm(path: str) -> WordLM:
    """Load a :class:`WordLM` saved by :func:`save_word_lm`."""
    z = np.load(path)
    for k in ("key1", "bkey1"):
        if k in z:
            S = z[k].shape[0]
            if S & (S - 1):
                raise ValueError(
                    f"{path}: table size {S} ({k}) is not a power of two")
    extra = {}
    if "bkey1" in z:
        extra = dict(bkey1=z["bkey1"], bkey2=z["bkey2"], blogp=z["blogp"],
                     backoff_log=float(z["backoff_log"]))
    return WordLM(key1=z["key1"], key2=z["key2"], logp=z["logp"],
                  oov_log_prob=float(z["oov_log_prob"]), **extra)


def estimate_bigram_lm(
    transcripts: Iterable[str],
    alphabet: Alphabet,
    *,
    smoothing: float = 1.0,
    blank_index: Optional[int] = None,
    vocab_size: Optional[int] = None,
) -> np.ndarray:
    """Estimate a ``(V+1, V)`` char-bigram log-prob matrix from text.

    Add-``smoothing`` (Laplace) estimate of ``log p(next | prev)`` over the
    alphabet.  ``V`` defaults to ``len(alphabet)`` but should be the model's
    vocab size (``builders.build.vocab_size``), which may exceed the
    alphabet by a dedicated blank row; row ``V`` is the sentence-start
    distribution.  The ``blank_index`` column gets (near) -inf mass — blank
    is never a real "next character" (the beam search only scores the LM on
    non-blank extensions anyway, so this is belt-and-braces).

    Returns float32; rows normalise over the V columns.
    """
    V = vocab_size or len(alphabet)
    if V < len(alphabet):
        raise ValueError(f"vocab_size {V} < alphabet size {len(alphabet)}")
    counts = np.full((V + 1, V), float(smoothing), np.float64)
    # Non-alphabet columns (e.g. a dedicated blank row past the alphabet)
    # carry no linguistic mass.
    counts[:, len(alphabet):] = 1e-20
    for line in transcripts:
        prev = START
        for ch in line:
            if ch not in alphabet:
                # Out-of-alphabet characters break the context (the
                # transcript cleaner should have removed them; be lenient
                # here so estimation works on raw text).
                prev = START
                continue
            cur = alphabet.get_index(ch)
            counts[prev if prev >= 0 else V, cur] += 1.0
            prev = cur
    if blank_index is not None and 0 <= blank_index < V:
        counts[:, blank_index] = 1e-20
    mat = np.log(counts / counts.sum(axis=1, keepdims=True))
    return mat.astype(np.float32)


def save_bigram_lm(path: str, lm: np.ndarray) -> None:
    """Save an LM matrix produced by :func:`estimate_bigram_lm` (.npy)."""
    lm = np.asarray(lm, np.float32)
    if lm.ndim != 2 or lm.shape[0] != lm.shape[1] + 1:
        raise ValueError(f"expected (V+1, V) matrix, got {lm.shape}")
    np.save(path, lm)


def load_bigram_lm(path: str, *, vocab_size: Optional[int] = None) -> np.ndarray:
    """Load a ``(V+1, V)`` LM matrix, validating shape against the vocab."""
    lm = np.load(path)
    if lm.ndim != 2 or lm.shape[0] != lm.shape[1] + 1:
        raise ValueError(f"{path}: expected (V+1, V) matrix, got {lm.shape}")
    if vocab_size is not None and lm.shape[1] != vocab_size:
        raise ValueError(
            f"{path}: LM vocab {lm.shape[1]} != model vocab {vocab_size}")
    return lm.astype(np.float32)
