"""Batching: padding collate + duration bucketing for static shapes.

The port's copy of ``myrtlespeech_tpu/data/batch.py`` (numpy only): the
same dataset, batch size, seed and epoch give the same batches, bit for
bit, in both packages.  On the card the buckets bound the distinct shapes
that the train step meets (cuDNN's and the allocator's caches), as they
bound XLA's recompiles in the JAX package.

Reference: ``src/myrtlespeech/data/batch.py :: seq_to_seq_collate_fn`` pads
each batch to its own max length — fine for eager PyTorch, fatal for XLA
(every new max shape recompiles).  The TPU-native design buckets batch
shapes to a small static set:

- audio lengths round up to the next member of a geometric bucket ladder;
- label lengths round up to a multiple of ``label_bucket``;
- so the number of distinct compiled ``train_step`` signatures is bounded
  by ``len(audio_buckets) * ceil(max_label / label_bucket)`` (SURVEY.md §7
  hard part 3: recompilation control).

The loader groups samples of similar duration into batches (minimising
padding waste) and yields numpy dicts ready for ``run/train.py::to_device``.
"""

from __future__ import annotations

import math
import subprocess
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from myrtlespeech_tpu_torch.data.alphabet import Alphabet


def geometric_buckets(min_len: int, max_len: int, growth: float = 1.26
                      ) -> Tuple[int, ...]:
    """Bucket ladder ``min_len * growth^k`` rounded to 128-sample multiples."""
    out = []
    x = float(min_len)
    while x < max_len:
        out.append(int(math.ceil(x / 128) * 128))
        x *= growth
    out.append(int(math.ceil(max_len / 128) * 128))
    return tuple(sorted(set(out)))


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")


def collate(samples: List[Tuple[np.ndarray, str]], alphabet: Alphabet,
            audio_pad_to: int, label_pad_to: int) -> Dict[str, np.ndarray]:
    """Pad a list of ``(waveform, transcript)`` into a dense batch dict."""
    B = len(samples)
    wav = np.zeros((B, audio_pad_to), np.float32)
    wav_lens = np.zeros((B,), np.int32)
    labels = np.zeros((B, label_pad_to), np.int32)
    label_lens = np.zeros((B,), np.int32)
    texts = []
    for i, (w, t) in enumerate(samples):
        wav[i, :len(w)] = w
        wav_lens[i] = len(w)
        idx = alphabet.get_indices(t)
        labels[i, :len(idx)] = idx
        label_lens[i] = len(idx)
        texts.append(t)
    return {"wav": wav, "wav_lens": wav_lens, "labels": labels,
            "label_lens": label_lens, "texts": texts}


class BucketedLoader:
    """Duration-bucketed batch iterator over a map-style dataset.

    Groups indices by audio bucket, shuffles within buckets each epoch, and
    emits fixed-shape batches.  ``drop_remainder`` keeps batch size static
    (required under jit/pjit); set ``pad_last`` to instead repeat the last
    sample (eval convenience — use the returned ``n_real`` to mask).
    """

    def __init__(self, dataset, alphabet: Alphabet, batch_size: int, *,
                 audio_buckets: Optional[Sequence[int]] = None,
                 bucket_growth: float = 1.26,
                 label_bucket: int = 32, shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = False,
                 shard_id: int = 0, num_shards: int = 1,
                 num_workers: int = 0, pack: bool = False):
        """``shard_id``/``num_shards``: per-host sharding for multi-host
        input pipelines (SURVEY.md §2.10 N6).

        Every host builds the IDENTICAL global batch plan (bucket edges
        from the whole dataset, one shared shuffle RNG) over global
        batches of ``batch_size * num_shards``, then emits only its
        contiguous ``batch_size``-row slice of each one.  This is what
        makes multi-process global arrays possible at all: the padded
        (audio bucket, label pad) shape of step k is a pure function of
        the shared plan, so all hosts' slices assemble into one
        consistent global batch (``jax.make_array_from_process_local_
        data``), and an N-process run sees bit-identical global batches
        to a 1-process run of the same config.  (The earlier design —
        each host bucketing its own ``i % num_shards`` subset — let
        bucket edges and per-step shapes drift between hosts, which
        deadlocks GSPMD the first time two hosts pad differently.)
        Deterministic datasets need no coordination.  Pass
        ``jax.process_index()/process_count()``."""
        self.ds = dataset
        self.alphabet = alphabet
        self.batch_size = batch_size
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.global_batch = batch_size * num_shards
        self.label_bucket = label_bucket
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        # Worker threads for sample fetch (audio read/decode/synthesis) —
        # the counterpart of the reference's DataLoader num_workers
        # processes (SURVEY.md §2.10 N6).  Threads suffice: decoding is
        # numpy/IO-bound and releases the GIL; 0 = synchronous.
        self.num_workers = num_workers
        # ``pack``: sorted-duration packing instead of per-bucket
        # grouping.  Eval corpora fragment badly under grouping (the
        # committed medium recipe's 256 eval utterances spread over 15
        # batches, 1.9x padding rows — round-5 eval breakdown); packing
        # sorts by duration and fills every batch, padding each chunk to
        # its longest member's bucket.  Same bucket ladder (no new
        # compiles), permutation-invariant metrics, so it is the eval
        # default in ``fit``; train keeps grouped+shuffled batches.
        self.pack = pack
        self._pool = None
        self._native_ok = None  # tri-state: unknown / usable / unavailable
        self._indices = list(range(len(dataset)))

        durations = {i: self._duration(i) for i in self._indices}
        self._durations = durations
        if audio_buckets is None:
            vals = list(durations.values())
            mx = max(vals) if vals else 16000
            mn = max(min(vals) if vals else 1600, 1600)
            audio_buckets = geometric_buckets(mn, max(mx, mn + 1),
                                              growth=bucket_growth)
        self.audio_buckets = tuple(audio_buckets)
        self._by_bucket: Dict[int, List[int]] = {}
        for i, d in durations.items():
            b = bucket_for(d, self.audio_buckets)
            self._by_bucket.setdefault(b, []).append(i)
        self._epoch = 0
        self._skip = 0

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Pin the shuffle epoch (and optionally a batch cursor) for the
        next ``__iter__``.

        The shuffle RNG is keyed on ``(seed, epoch)`` so data order is a
        pure function of the epoch number — exact checkpoint resume
        (VERDICT r1 #6) re-creates a loader, calls ``set_epoch(e, skip)``
        and sees the identical remaining batch sequence.  Without this
        call, epochs count up from 0 as before.
        """
        self._epoch = epoch
        self._skip = skip_batches

    def _duration(self, i: int) -> int:
        if hasattr(self.ds, "duration_samples"):
            d = self.ds.duration_samples(i)
            if d > 0:
                return d
        return len(self.ds[i][0])

    def __len__(self) -> int:
        if self.pack:
            n = len(self._indices)
            return n // self.global_batch if self.drop_remainder \
                else math.ceil(n / self.global_batch)
        n = 0
        for idxs in self._by_bucket.values():
            if self.drop_remainder:
                n += len(idxs) // self.global_batch
            else:
                n += math.ceil(len(idxs) / self.global_batch)
        return n

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        skip, self._skip = self._skip, 0  # cursor applies to one epoch only
        GB = self.global_batch
        plan = []  # (bucket, [global chunk indices], n_real_global)
        if self.pack:
            order = sorted(self._indices, key=lambda i: self._durations[i])
            for k in range(0, len(order), GB):
                chunk = order[k:k + GB]
                n_real = len(chunk)
                if n_real < GB:
                    if self.drop_remainder:
                        continue
                    chunk = chunk + [chunk[-1]] * (GB - n_real)
                b = bucket_for(max(self._durations[i] for i in chunk),
                               self.audio_buckets)
                plan.append((b, chunk, n_real))
        else:
            for b, idxs in sorted(self._by_bucket.items()):
                idxs = list(idxs)
                if self.shuffle:
                    rng.shuffle(idxs)
                for k in range(0, len(idxs), GB):
                    chunk = idxs[k:k + GB]
                    if len(chunk) < GB:
                        if self.drop_remainder:
                            continue
                        chunk = chunk + [chunk[-1]] * (GB - len(chunk))
                    plan.append((b, chunk, min(len(idxs) - k, GB)))
        if self.shuffle:
            rng.shuffle(plan)
        if self.num_workers > 0 and self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(self.num_workers)
        lo = self.shard_id * self.batch_size
        for bucket, chunk, n_real in plan[skip:]:
            # Label pad must be a pure function of the GLOBAL chunk so
            # all hosts' slices share one global shape; when sharded,
            # compute it from transcript metadata (or, failing that, by
            # materialising the whole chunk) before slicing.
            label_pad = None
            if self.num_shards > 1:
                label_pad = self._global_label_pad(chunk)
            local = chunk[lo:lo + self.batch_size]
            n_real_local = max(0, min(n_real - lo, self.batch_size))
            batch = self._native_batch(bucket, local, label_pad)
            if batch is None:
                if self._pool is not None:
                    samples = list(self._pool.map(self.ds.__getitem__,
                                                  local))
                else:
                    samples = [self.ds[i] for i in local]
                if label_pad is None:
                    label_max = max(1, max(len(t) for _, t in samples))
                    label_pad = math.ceil(label_max / self.label_bucket) \
                        * self.label_bucket
                batch = collate(samples, self.alphabet, bucket, label_pad)
            # ``n_real`` is the GLOBAL real count: inside jit the loss
            # mask is ``arange(global_B) < n_real`` and padding
            # duplicates sit at the global tail by construction.
            # ``texts`` is trimmed to the LOCAL real rows so host-side
            # consumers (WER accumulation) never score padding.
            batch["texts"] = batch["texts"][:n_real_local]
            batch["n_real"] = np.asarray(n_real, np.int32)
            if self.num_shards > 1:
                # Local real count for process-local eval steps (the
                # multi-host eval path masks with this instead).
                batch["n_real_local"] = np.asarray(n_real_local, np.int32)
            yield batch

    def _global_label_pad(self, chunk) -> int:
        """Label pad of a GLOBAL chunk from transcript metadata.

        Uses ``ds.transcript(i)`` when the dataset exposes it (all
        in-tree datasets do) so no remote host's audio is materialised;
        falls back to fetching the samples."""
        if hasattr(self.ds, "transcript"):
            lens = [len(self.alphabet.get_indices(self.ds.transcript(i)))
                    for i in chunk]
        else:
            lens = [len(self.alphabet.get_indices(self.ds[i][1]))
                    for i in chunk]
        label_max = max(1, max(lens))
        return math.ceil(label_max / self.label_bucket) * self.label_bucket

    def _native_batch(self, bucket: int, chunk,
                      label_pad: Optional[int] = None) -> Optional[Dict]:
        """Assemble one batch via the C++ batch decoder when possible.

        Requires the dataset to expose ``audio_path``/``transcript`` and
        every item in the chunk to be native-readable (WAV); the decoder
        (``native/audio_io.cc``, OpenMP) writes float32 frames straight
        into the padded (B, bucket) buffer — the reference's C++
        DataLoader-worker equivalent (SURVEY.md §2.10 N6).  Returns None
        to fall back to the per-sample Python path.
        """
        if self._native_ok is False or not hasattr(self.ds, "audio_path"):
            return None
        paths = [self.ds.audio_path(i) for i in chunk]
        if any(p is None for p in paths):
            return None
        try:
            from myrtlespeech_tpu_torch import native
            wav, wav_lens, _rates = native.wav_read_batch(paths, bucket)
            self._native_ok = True
        except (ImportError, OSError, subprocess.CalledProcessError):
            if self._native_ok is None:  # no toolchain/lib: stop retrying
                self._native_ok = False
            return None
        texts = [self.ds.transcript(i) for i in chunk]
        if label_pad is None:
            label_max = max(1, max(len(t) for t in texts))
            label_pad = math.ceil(label_max / self.label_bucket) \
                * self.label_bucket
        labels = np.zeros((len(chunk), label_pad), np.int32)
        label_lens = np.zeros((len(chunk),), np.int32)
        for i, t in enumerate(texts):
            idx = self.alphabet.get_indices(t)
            labels[i, :len(idx)] = idx
            label_lens[i] = len(idx)
        return {"wav": wav, "wav_lens": wav_lens, "labels": labels,
                "label_lens": label_lens, "texts": texts}


class PrefetchLoader:
    """Background-thread prefetching wrapper around any batch iterable.

    The TPU-native equivalent of the reference's multi-process torch
    DataLoader workers (SURVEY.md §2.10 N6): batch assembly (audio read +
    collate) overlaps with device compute.  Threads suffice here because
    collate is numpy/IO-bound and releases the GIL.

    Unlike the JAX package's, a consumer that stops early (``fit`` under
    ``StopEpochAfter``) stops the worker: closing the iterator drains the
    queue until the worker, which checks a stop flag between batches, has
    ended.  The JAX package's worker stays blocked on its full queue for the
    rest of the process, holding its batches.
    """

    def __init__(self, loader, prefetch: int = 2):
        self.loader = loader
        self.prefetch = prefetch

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        self.loader.set_epoch(epoch, skip_batches)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        SENTINEL = object()
        err: list = []
        stop = threading.Event()

        def worker():
            try:
                for batch in self.loader:
                    if stop.is_set():
                        break
                    q.put(batch)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                # Propagate to the consumer: a swallowed worker crash
                # would silently truncate the epoch (found by an e2e
                # drive where an OOV transcript crashed collate and fit
                # "succeeded" with 0 batches).
                err.append(e)
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    break
                yield item
        finally:
            stop.set()
            while t.is_alive():  # unblock the worker's put until it ends
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
        if err:
            raise err[0]
