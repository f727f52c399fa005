"""The port's LM tables (``decoding/lm.py``) against the JAX package's, on
the CPU.

Both packages estimate the char-bigram matrix and the word unigram and
bigram hash tables from the same transcripts (the synthetic corpus's train
split, in-repo), save them, and load each other's files; the port's word-LM
lookups on ``int64`` tensors score every stored word and some misses as the
JAX package's uint32 lookups do.  Everything is numpy or integer work, so
the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtlespeech_tpu.data.alphabet import Alphabet as JaxAlphabet
from myrtlespeech_tpu.decoding import ctc_beam as jax_beam
from myrtlespeech_tpu.decoding import lm as jax_lm
from myrtlespeech_tpu_torch.config.schema import SyntheticSpeechConfig
from myrtlespeech_tpu_torch.data.alphabet import Alphabet
from myrtlespeech_tpu_torch.data.dataset.synthetic import SyntheticSpeech
from myrtlespeech_tpu_torch.decoding import ctc_beam as port_beam
from myrtlespeech_tpu_torch.decoding import lm as port_lm

ALPHABET = "_ abcdefghijklmnopqrstuvwxyz'"  # deep_speech_2_en's, blank 0


def corpus(n: int = 256):
    ds = SyntheticSpeech(SyntheticSpeechConfig(dataset_len=n, split="train"))
    return [ds.transcript(i) for i in range(n)]


@pytest.fixture(scope="module")
def transcripts():
    return corpus()


@pytest.mark.parametrize("alphabet,kw", [
    (ALPHABET, dict(blank_index=0)),
    ("abcdefghijklmnopqrstuvwxyz ", dict(blank_index=27, vocab_size=28)),
    ("abcdefghijklmnopqrstuvwxyz ", dict(smoothing=0.1)),
], ids=["ds2_blank0", "blank_last", "no_blank"])
def test_char_bigram_equals_jax(transcripts, alphabet, kw):
    # One out-of-alphabet character breaks a context in each package.
    lines = transcripts + ["ab#cd"]
    want = jax_lm.estimate_bigram_lm(lines, JaxAlphabet(alphabet), **kw)
    got = port_lm.estimate_bigram_lm(lines, Alphabet(alphabet), **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _word_lms(transcripts, order):
    kw = dict(order=order, smoothing=0.5)
    return (jax_lm.estimate_word_lm(transcripts, JaxAlphabet(ALPHABET), **kw),
            port_lm.estimate_word_lm(transcripts, Alphabet(ALPHABET), **kw))


def _assert_word_lms_equal(got, want):
    for name in ("key1", "key2", "logp", "bkey1", "bkey2", "blogp"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.oov_log_prob == want.oov_log_prob
    assert got.backoff_log == want.backoff_log


@pytest.mark.parametrize("order", [1, 2])
def test_word_lm_tables_equal_jax(transcripts, order):
    want, got = _word_lms(transcripts, order)
    _assert_word_lms_equal(got, want)
    assert (got.bkey1 is not None) == (order == 2)


@pytest.mark.parametrize("kind", ["char_bigram", "word_unigram",
                                  "word_bigram"])
@pytest.mark.parametrize("saver", ["jax_saves", "port_saves"])
def test_lm_files_load_in_the_other_package(tmp_path, transcripts, kind,
                                            saver):
    save, load = ((jax_lm, port_lm) if saver == "jax_saves"
                  else (port_lm, jax_lm))
    if kind == "char_bigram":
        lm = save.estimate_bigram_lm(transcripts, Alphabet(ALPHABET),
                                     blank_index=0)
        path = str(tmp_path / "lm.npy")
        save.save_bigram_lm(path, lm)
        np.testing.assert_array_equal(
            load.load_bigram_lm(path, vocab_size=len(ALPHABET)), lm)
        return
    lm = save.estimate_word_lm(transcripts, Alphabet(ALPHABET),
                               order=1 if kind == "word_unigram" else 2)
    path = str(tmp_path / "words.npz")
    save.save_word_lm(path, lm)
    # The file keeps the scalars in float32: each package loads the same.
    _assert_word_lms_equal(load.load_word_lm(path), save.load_word_lm(path))
    np.testing.assert_array_equal(load.load_word_lm(path).key1, lm.key1)


def test_word_hashes_and_bigram_keys_wrap_as_uint32():
    rng = np.random.default_rng(0)
    for _ in range(20):
        word = rng.integers(0, 29, int(rng.integers(1, 12)))
        assert port_lm.word_hashes(word) == jax_lm.word_hashes(word)
    p1, p2, h1, h2 = rng.integers(0, 2**32, (4, 1000), dtype=np.uint32)
    want = jax_lm.bigram_keys(jnp.asarray(p1), jnp.asarray(p2),
                              jnp.asarray(h1), jnp.asarray(h2))
    got = port_beam.bigram_keys(*(torch.as_tensor(a.astype(np.int64))
                                  for a in (p1, p2, h1, h2)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))


def _jax_tables(lm):
    """The JAX beam search's device form of a WordLM (``ctc_beam_decode``)."""
    wl = dict(key1=jnp.asarray(lm.key1), key2=jnp.asarray(lm.key2),
              logp=jnp.asarray(lm.logp), oov=jnp.float32(lm.oov_log_prob),
              bkey1=None, bkey2=None, blogp=None, backoff=None)
    if lm.bkey1 is not None:
        wl.update(bkey1=jnp.asarray(lm.bkey1), bkey2=jnp.asarray(lm.bkey2),
                  blogp=jnp.asarray(lm.blogp),
                  backoff=jnp.float32(lm.backoff_log))
    return wl


@pytest.mark.parametrize("order", [1, 2])
def test_word_lm_lookups_equal_jax(transcripts, order):
    """Every stored word in each context it follows in the corpus (the
    sentence start included), every word after a random context, and
    random misses: equal float32 scores."""
    _, lm = _word_lms(transcripts, order)
    alphabet = Alphabet(ALPHABET)
    seed = (np.uint32(port_lm.WORD_SEED1), np.uint32(port_lm.WORD_SEED2))
    pairs = []
    for line in transcripts:
        prev = seed
        for word in line.split(" "):
            cur = port_lm.word_hashes(alphabet.get_indices(word))
            pairs.append((prev, cur))
            prev = cur
    rng = np.random.default_rng(1)
    rand = rng.integers(0, 2**32, (200, 2), dtype=np.uint32)
    stored = {cur for _, cur in pairs}
    assert len(stored) == int((lm.key1 != 0).sum())  # every stored word
    pairs += [((a, b), cur) for (a, b), (_, cur) in zip(rand, pairs)]
    pairs += [(seed, (a, b)) for a, b in rand]
    pairs.append((seed, (np.uint32(0), np.uint32(0))))  # the empty marker
    arr = np.array([[p[0], p[1], c[0], c[1]] for p, c in pairs], np.uint32)
    want = jax_beam._word_lm_score(_jax_tables(lm),
                                   *(jnp.asarray(a) for a in arr.T))
    got = port_beam._word_lm_score(
        port_beam.WordLMTensors.from_word_lm(lm),
        *(torch.as_tensor(a.astype(np.int64)) for a in arr.T),
        torch.arange(port_lm.WORD_LM_PROBES))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Both tables are hit and missed.
    h = [torch.as_tensor(a.astype(np.int64)) for a in arr.T]
    tables = [(lm.key1, lm.key2, lm.logp, h[2], h[3])]
    if order == 2:
        tables.append((lm.bkey1, lm.bkey2, lm.blogp,
                       *port_beam.bigram_keys(*h)))
    for k1, k2, logp, a, b in tables:
        _, found = port_beam._word_lm_lookup(
            torch.as_tensor(k1.astype(np.int64)),
            torch.as_tensor(k2.astype(np.int64)), torch.as_tensor(logp),
            0.0, a, b, torch.arange(port_lm.WORD_LM_PROBES))
        assert 64 < int(found.sum()) < len(found)
