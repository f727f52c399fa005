"""The CTC decode fixture: JAX's outputs on seeded logits, for the card.

    python -m port_tools.ctc_decode_fixture

writes ``port_tools/ctc_decode_fixture.npz`` on the CPU: B=4 blank-heavy
seeded logits at DeepSpeech2's lattice (T'=836, V=29, ragged lengths), the
char-bigram and word-bigram LM tables estimated from the synthetic corpus's
train transcripts, and the JAX package's tokens and lengths for

- ``beam``: ``deep_speech_2_en``'s own decoder (W=16, ``expand_topk=16``,
  prune 1e-3);
- ``exact``: the same with every symbol expanded (``expand_topk=None``);
- ``char_lm``: ``beam`` with the char bigram at ``lm_alpha=0.5``;
- ``word_lm``: ``beam`` with the word bigram LM (separator 1, the space,
  ``word_lm_alpha=1.0``, ``word_count_beta=6.0``);
- ``greedy``.

The card has no JAX: ``chip_smoke.py`` decodes the stored logits with the
port (:func:`port_decodes`) and holds each output to the stored one
exactly.  The npz also keeps the seed, the JAX and numpy versions and this
command.  ``tests/test_torch_ctc_decoders.py`` re-decodes one row with JAX,
so the fixture cannot go stale.  Only :func:`main` imports JAX.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from myrtlespeech_tpu_torch.config.schema import SyntheticSpeechConfig
from myrtlespeech_tpu_torch.data.alphabet import Alphabet
from myrtlespeech_tpu_torch.data.dataset.synthetic import SyntheticSpeech
from myrtlespeech_tpu_torch.decoding import lm
from myrtlespeech_tpu_torch.decoding.ctc_beam import ctc_beam_decode
from myrtlespeech_tpu_torch.decoding.ctc_greedy import ctc_greedy_decode

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "ctc_decode_fixture.npz")
SEED = 0
ALPHABET = "_ abcdefghijklmnopqrstuvwxyz'"  # deep_speech_2_en's
B, T, V = 4, 836, 29
LENS = (836, 700, 511, 298)
_WORD = ("key1", "key2", "logp", "bkey1", "bkey2", "blogp")
# The cases besides greedy: decoder keywords, LM tables named by key.
CASES = {
    "beam": dict(beam_width=16, prune_threshold=1e-3, expand_topk=16),
    "exact": dict(beam_width=16, prune_threshold=1e-3, expand_topk=None),
    "char_lm": dict(beam_width=16, prune_threshold=1e-3, expand_topk=16,
                    lm_alpha=0.5, lm_bigram="char_lm"),
    "word_lm": dict(beam_width=16, prune_threshold=1e-3, expand_topk=16,
                    separator_index=1, word_lm_alpha=1.0,
                    word_count_beta=6.0, word_lm="word_lm"),
}


def make_logits(seed: int = SEED):
    """Blank-heavy ``(B, T, V)`` float32 logits and ``(B,)`` lengths: the
    blank leads by some 4 nats on most frames; a symbol (a letter, the
    space or the apostrophe) peaks on about one frame in four, for one to
    three frames, and on one of those frames in three a rival symbol comes
    within a nat of it, so the beam and greedy disagree at places."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    logits[..., 0] += 4.0
    for b in range(B):
        t = 0
        while t < T:
            if rng.random() < 0.25:
                n = int(rng.integers(1, 4))
                sym = int(rng.integers(1, V))
                logits[b, t:t + n, sym] += 6.0 + rng.random()
                if rng.random() < 1 / 3:
                    rival = int(rng.integers(1, V))
                    logits[b, t:t + n, rival] += 5.0 + 2 * rng.random()
                t += n
            t += 1
    return logits, np.array(LENS, np.int32)


def lm_tables(n: int = 512) -> Dict[str, np.ndarray]:
    """The char bigram (``char_lm``) and the word bigram LM's arrays and
    scalars (``word_lm_*``) of the first ``n`` synthetic train transcripts
    over DeepSpeech2's alphabet."""
    ds = SyntheticSpeech(SyntheticSpeechConfig(dataset_len=n, split="train"))
    lines = [ds.transcript(i) for i in range(n)]
    alphabet = Alphabet(ALPHABET)
    words = lm.estimate_word_lm(lines, alphabet, order=2)
    out = {"char_lm": lm.estimate_bigram_lm(lines, alphabet, blank_index=0)}
    out.update({f"word_lm_{k}": getattr(words, k) for k in _WORD})
    out["word_lm_oov"] = np.float32(words.oov_log_prob)
    out["word_lm_backoff"] = np.float32(words.backoff_log)
    return out


def word_lm(data) -> lm.WordLM:
    return lm.WordLM(**{k: data[f"word_lm_{k}"] for k in _WORD},
                     oov_log_prob=float(data["word_lm_oov"]),
                     backoff_log=float(data["word_lm_backoff"]))


def decoders(data) -> Dict[str, dict]:
    """Each beam case's decoder keywords, its LM tables from ``data``."""
    out = {}
    for name, kw in CASES.items():
        kw = dict(kw)
        if "lm_bigram" in kw:
            kw["lm_bigram"] = data[kw["lm_bigram"]]
        if "word_lm" in kw:
            kw["word_lm"] = word_lm(data)
        out[name] = kw
    return out


def port_decodes(data, device) -> Dict[str, tuple]:
    """The port's ``(tokens, lens)`` of every case on ``device``."""
    logits = torch.as_tensor(data["logits"], device=device)
    lens = torch.as_tensor(data["lens"], device=device)
    out = {name: ctc_beam_decode(logits, lens, **kw)
           for name, kw in decoders(data).items()}
    out["greedy"] = ctc_greedy_decode(logits, lens)
    return {k: tuple(a.cpu() for a in v) for k, v in out.items()}


def main() -> None:
    import jax
    import jax.numpy as jnp

    from myrtlespeech_tpu.decoding import lm as jax_lm
    from myrtlespeech_tpu.decoding.ctc_beam import ctc_beam_decode as beam
    from myrtlespeech_tpu.decoding.ctc_greedy import \
        ctc_greedy_decode as greedy

    jax.config.update("jax_platforms", "cpu")
    logits, lens = make_logits()
    data = {"logits": logits, "lens": lens, **lm_tables()}
    out = dict(data, seed=np.int64(SEED),
               jax_version=np.str_(jax.__version__),
               numpy_version=np.str_(np.__version__),
               command=np.str_("python -m port_tools.ctc_decode_fixture"),
               cases=np.str_(json.dumps(CASES)))
    x, n = jnp.asarray(logits), jnp.asarray(lens)
    for name, kw in decoders(data).items():
        if "word_lm" in kw:
            kw["word_lm"] = jax_lm.WordLM(**vars(kw["word_lm"]))
        toks, tlens = beam(x, n, **kw)
        out[f"{name}_tokens"], out[f"{name}_lens"] = (np.asarray(toks),
                                                      np.asarray(tlens))
    toks, tlens = greedy(x, n)
    out["greedy_tokens"], out["greedy_lens"] = (np.asarray(toks),
                                                np.asarray(tlens))
    np.savez_compressed(PATH, **out)
    print(json.dumps({
        "path": PATH, "bytes": os.path.getsize(PATH),
        "lens": {k[:-5]: out[k].tolist() for k in out
                 if k.endswith("_lens") and k != "lens"}}))


if __name__ == "__main__":
    main()
