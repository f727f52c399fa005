"""ctypes bindings for the native host-side runtime (C++).

The port's copy of ``myrtlespeech_tpu/native/``: batched edit distance and
a batched WAV reader, host code (not a device kernel).  The library is not
committed: the first call builds it with ``make`` (``g++ -fopenmp``) into
``native/build/``, which ``.gitignore`` lists, through a temporary file and
a rename so that processes building at once do not clash.  Without a
compiler the build raises ``OSError``/``CalledProcessError``, and callers
fall back to pure Python (``decoding/wer.py``, ``data/batch.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "build", "libmyrtle_native.so")
_lib = None


def _build() -> None:
    """Compile the library into ``build/`` (atomically: another process may
    be building it at the same time)."""
    tmp = f"build/libmyrtle_native.so.{os.getpid()}.tmp"
    subprocess.run(["make", "-C", _DIR, f"OUT={tmp}"], check=True,
                   capture_output=True)
    os.replace(os.path.join(_DIR, tmp), _LIB_PATH)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _build()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.edit_distance_batch_i32.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
    lib.edit_distance_batch_i32.restype = None
    lib.wav_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32)]
    lib.wav_info.restype = ctypes.c_int
    lib.wav_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.wav_read_batch.restype = ctypes.c_int64
    _lib = lib
    return lib


def _flatten(seqs: List[Sequence[int]]):
    offsets = np.zeros(len(seqs) + 1, np.int64)
    for i, s in enumerate(seqs):
        offsets[i + 1] = offsets[i] + len(s)
    flat = np.fromiter((t for s in seqs for t in s), np.int32,
                       count=int(offsets[-1]))
    return flat, offsets


def edit_distance_batch(refs: List[Sequence], hyps: List[Sequence]
                        ) -> List[int]:
    """Batched edit distance over token sequences (any hashable tokens)."""
    lib = _load()
    # Intern arbitrary tokens to int32 ids.
    vocab = {}
    def ids(seq):
        out = []
        for t in seq:
            if t not in vocab:
                vocab[t] = len(vocab)
            out.append(vocab[t])
        return out

    r_flat, r_off = _flatten([ids(r) for r in refs])
    h_flat, h_off = _flatten([ids(h) for h in hyps])
    n = len(refs)
    out = np.zeros(n, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    # Guard against zero-size arrays (ctypes rejects NULL-able casts).
    r_flat = np.ascontiguousarray(r_flat) if r_flat.size else np.zeros(1, np.int32)
    h_flat = np.ascontiguousarray(h_flat) if h_flat.size else np.zeros(1, np.int32)
    lib.edit_distance_batch_i32(
        r_flat.ctypes.data_as(i32p), r_off.ctypes.data_as(i64p),
        h_flat.ctypes.data_as(i32p), h_off.ctypes.data_as(i64p),
        ctypes.c_int64(n), out.ctypes.data_as(i32p))
    return out.tolist()


def wav_info(path: str):
    """Header-only (n_samples, sample_rate) — fast corpus indexing."""
    lib = _load()
    n = ctypes.c_int64(0)
    sr = ctypes.c_int32(0)
    rc = lib.wav_info(path.encode(), ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        raise OSError(f"wav_info({path!r}) failed with code {rc}")
    return int(n.value), int(sr.value)


def wav_read_batch(paths: Sequence[str], max_samples: int):
    """Decode a batch of WAV files in parallel (OpenMP) into a padded
    (B, max_samples) float32 array.

    The native counterpart of the reference's DataLoader-worker decode
    (SURVEY.md §2.10 N6): one call per batch, frames written directly
    into the collate buffer.  Returns ``(wav, lengths, sample_rates)``.
    Raises OSError naming the first failing file (unreadable, unsupported
    format, or longer than ``max_samples``).
    """
    lib = _load()
    n = len(paths)
    wav = np.zeros((n, max_samples), np.float32)
    lens = np.zeros((n,), np.int32)
    rates = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failed = lib.wav_read_batch(
        c_paths, ctypes.c_int64(n),
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(max_samples),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if failed >= 0:
        raise OSError(
            f"wav_read_batch: file {paths[failed]!r} failed "
            f"(code {int(lens[failed])}; -2 open, -3 parse, -4 format, "
            f"-5 longer than max_samples={max_samples})")
    return wav, lens, rates
