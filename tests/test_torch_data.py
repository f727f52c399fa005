"""The port's data path against the JAX package's: datasets, bucketing,
``collate``, ``BucketedLoader`` (every key of every batch, bit for bit, in
each case the run loop uses), ``PrefetchLoader``, the LibriSpeech reader on
files the test writes, and the native library built from the port's own
sources."""

import os
import threading
import time
import wave

import numpy as np
import pytest

from myrtlespeech_tpu import native as jax_native
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.data import batch as jax_batch
from myrtlespeech_tpu.data.alphabet import Alphabet as JaxAlphabet
from myrtlespeech_tpu.data.dataset.fake import FakeSpeechToText as JaxFake
from myrtlespeech_tpu.data.dataset.librispeech import \
    LibriSpeech as JaxLibriSpeech
from myrtlespeech_tpu.data.dataset.synthetic import \
    SyntheticSpeech as JaxSynthetic
from myrtlespeech_tpu_torch import native
from myrtlespeech_tpu_torch.builders.build import build_dataset
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.data import batch
from myrtlespeech_tpu_torch.data.alphabet import Alphabet
from myrtlespeech_tpu_torch.data.dataset.librispeech import LibriSpeech

ALPHABET = "_ abcdefghijklmnopqrstuvwxyz'"
KEYS = ("wav", "wav_lens", "labels", "label_lens", "texts", "n_real")
# A sharded loader's batches also hold ``n_real_local``.


def _fake(S, n=40, seed=0):
    return S.FakeSpeechToTextConfig(
        dataset_len=n, audio_ms=S.IntRange(100, 900),
        label_symbols="abc ", label_len=S.IntRange(1, 12), seed=seed)


def _synthetic(S, n=24):
    return S.SyntheticSpeechConfig(dataset_len=n, split="eval", seed=3,
                                   max_words=3)


def _datasets(kind):
    if kind == "fake":
        return build_dataset(_fake(PS)), JaxFake(_fake(JS))
    return build_dataset(_synthetic(PS)), JaxSynthetic(_synthetic(JS))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) >= set(KEYS)
        for k in w:
            if k == "texts":
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_fake_items_equal_jax():
    port, jax = _datasets("fake")
    assert len(port) == len(jax)
    for i in range(len(jax)):
        (pw, pt), (jw, jt) = port[i], jax[i]
        assert pt == jt and port.transcript(i) == jax.transcript(i)
        assert pw.dtype == jw.dtype
        np.testing.assert_array_equal(pw, jw)
        assert port.duration_samples(i) == jax.duration_samples(i)


def test_buckets_and_collate_equal_jax():
    for args in ((1600, 16000), (1600, 16001, 1.5), (3000, 250000, 1.1)):
        assert batch.geometric_buckets(*args) == \
            jax_batch.geometric_buckets(*args)
    ladder = batch.geometric_buckets(1600, 16000)
    for n in (1, 1600, 1601, 16000):
        assert batch.bucket_for(n, ladder) == jax_batch.bucket_for(n, ladder)
    with pytest.raises(ValueError, match="exceeds"):
        batch.bucket_for(ladder[-1] + 1, ladder)
    port, jax = _datasets("fake")
    samples = [jax[i] for i in range(5)]
    got = batch.collate(samples, Alphabet(ALPHABET), 16000, 32)
    want = jax_batch.collate(samples, JaxAlphabet(ALPHABET), 16000, 32)
    want["n_real"] = got["n_real"] = np.asarray(5, np.int32)
    _assert_batches_equal([got], [want])


# (dataset, loader kwargs, epochs to run, set_epoch(1, skip) first)
CASES = {
    "fake_shuffled_two_epochs": ("fake", {}, 2, None),
    "fake_in_order": ("fake", {"shuffle": False}, 1, None),
    "fake_resume_cursor": ("fake", {}, 1, 2),
    "fake_pack": ("fake", {"pack": True, "shuffle": False}, 1, None),
    "fake_two_workers": ("fake", {"num_workers": 2}, 2, None),
    "fake_drop_remainder": ("fake", {"drop_remainder": True}, 1, None),
    "fake_shard_0_of_2": ("fake", {"shard_id": 0, "num_shards": 2}, 1, None),
    "fake_shard_1_of_2": ("fake", {"shard_id": 1, "num_shards": 2}, 1, None),
    "synthetic_shuffled": ("synthetic", {}, 2, None),
    "synthetic_pack": ("synthetic", {"pack": True, "shuffle": False}, 1,
                       None),
}


def _run(module, ds, alphabet, kwargs, epochs, skip, prefetch):
    kwargs = dict(kwargs)
    kwargs.setdefault("seed", 7)
    kwargs.setdefault("label_bucket", 8)
    loader = module.BucketedLoader(ds, alphabet, 4, **kwargs)
    if prefetch:
        loader = module.PrefetchLoader(loader, 2)
    out = []
    if skip is not None:
        loader.set_epoch(1, skip_batches=skip)
    for _ in range(epochs):
        out.append(len(loader))
        batches = list(loader)
        out.extend(batches)
    return out


def _split(seq):
    lens = [x for x in seq if isinstance(x, int)]
    return lens, [x for x in seq if not isinstance(x, int)]


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["direct", "prefetch"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bucketed_loader_equals_jax_bit_for_bit(case, prefetch):
    kind, kwargs, epochs, skip = CASES[case]
    port, jax = _datasets(kind)
    got = _run(batch, port, Alphabet(ALPHABET), kwargs, epochs, skip,
               prefetch)
    want = _run(jax_batch, jax, JaxAlphabet(ALPHABET), kwargs, epochs, skip,
                prefetch)
    (glen, gb), (wlen, wb) = _split(got), _split(want)
    assert glen == wlen
    _assert_batches_equal(gb, wb)


def test_epoch_order_is_a_function_of_seed_and_epoch():
    port, _ = _datasets("fake")
    loader = batch.BucketedLoader(port, Alphabet(ALPHABET), 4, seed=7)
    first, second = list(loader), list(loader)
    loader.set_epoch(1)
    again = list(loader)
    assert [b["texts"] for b in second] == [b["texts"] for b in again]
    assert [b["texts"] for b in first] != [b["texts"] for b in second]
    loader.set_epoch(1, skip_batches=3)
    assert [b["texts"] for b in loader] == [b["texts"] for b in again[3:]]


def test_prefetch_loader_raises_the_workers_error():
    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("bad item")
            return np.zeros(1600, np.float32), "a"

        def duration_samples(self, i):
            return 1600

    loader = batch.PrefetchLoader(batch.BucketedLoader(
        Broken(), Alphabet(ALPHABET), 1, shuffle=False), 2)
    with pytest.raises(KeyError, match="bad item"):
        list(loader)


def _write_wav(path, pcm, sr=16000):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def _corpus(root, subset="dev-clean"):
    """Two speakers, two chapters, five utterances of 16-bit wav with
    their transcripts, in LibriSpeech's layout."""
    rng = np.random.default_rng(0)
    words = ["HELLO", "WORLD", "A", "CAT'S", "TAIL"]
    k = 0
    for spk, ch in ((19, 198), (26, 495)):
        d = root / subset / str(spk) / str(ch)
        d.mkdir(parents=True)
        lines = []
        for utt in range(3 if spk == 19 else 2):
            uid = f"{spk}-{ch}-{utt:04d}"
            n = int(rng.integers(2000, 9000))
            _write_wav(d / f"{uid}.wav",
                       (rng.standard_normal(n) * 3000).astype(np.int16))
            lines.append(f"{uid} {' '.join(words[k % 5:k % 5 + 2])}")
            k += 1
        (d / f"{spk}-{ch}.trans.txt").write_text("\n".join(lines) + "\n")


def test_librispeech_indexes_and_reads_as_jax(tmp_path):
    _corpus(tmp_path)
    cfg = dict(data_dir=str(tmp_path), max_duration_s=0.4)
    port = LibriSpeech(PS.LibriSpeechConfig(
        subsets=(PS.LibriSpeechSubset.DEV_CLEAN,), **cfg))
    os.remove(tmp_path / "dev-clean" / ".myrtlespeech_tpu_index.json")
    jax = JaxLibriSpeech(JS.LibriSpeechConfig(
        subsets=(JS.LibriSpeechSubset.DEV_CLEAN,), **cfg))
    assert port.entries == jax.entries and 0 < len(port) < 5
    for i in range(len(jax)):
        (pw, pt), (jw, jt) = port[i], jax[i]
        assert pt == jt == jt.lower()
        np.testing.assert_array_equal(pw, jw)
        assert port.audio_path(i) == jax.audio_path(i)
        assert port.duration_samples(i) == jax.duration_samples(i)
    # The loaders read the wavs through each package's native library.
    port_loader = batch.BucketedLoader(port, Alphabet(ALPHABET), 2, seed=1,
                                       label_bucket=8)
    jax_loader = jax_batch.BucketedLoader(jax, JaxAlphabet(ALPHABET), 2,
                                          seed=1, label_bucket=8)
    _assert_batches_equal(list(port_loader), list(jax_loader))
    assert port_loader._native_ok is True and jax_loader._native_ok is True
    with pytest.raises(FileNotFoundError, match="download"):
        LibriSpeech(PS.LibriSpeechConfig(
            data_dir=str(tmp_path / "none"),
            subsets=(PS.LibriSpeechSubset.DEV_CLEAN,)))


def test_native_library_built_from_the_ports_sources(tmp_path):
    native._load()
    assert native._LIB_PATH.startswith(os.path.dirname(native.__file__))
    assert os.path.exists(native._LIB_PATH)
    rng = np.random.default_rng(0)
    refs = [list(rng.integers(0, 5, int(rng.integers(0, 12))))
            for _ in range(30)]
    hyps = [list(rng.integers(0, 5, int(rng.integers(0, 12))))
            for _ in range(30)]
    refs.append("the cat sat".split())
    hyps.append("a cat sat down".split())
    assert native.edit_distance_batch(refs, hyps) == \
        jax_native.edit_distance_batch(refs, hyps)
    paths = []
    for i, n in enumerate((1600, 2300, 17)):
        p = tmp_path / f"{i}.wav"
        _write_wav(p, (rng.standard_normal(n) * 9000).astype(np.int16))
        paths.append(str(p))
    assert native.wav_info(paths[1]) == jax_native.wav_info(paths[1])
    for got, want in zip(native.wav_read_batch(paths, 2400),
                         jax_native.wav_read_batch(paths, 2400)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(OSError, match="longer than max_samples"):
        native.wav_read_batch(paths, 100)


def test_prefetch_worker_stops_when_the_consumer_stops():
    port, _ = _datasets("fake")
    loader = batch.PrefetchLoader(batch.BucketedLoader(
        port, Alphabet(ALPHABET), 1, shuffle=False), 1)
    before = threading.active_count()
    for i, _ in enumerate(loader):
        if i == 2:
            break  # the for loop drops, and so closes, the iterator
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before
