"""LibriSpeech dataset reader.

The port's copy of ``myrtlespeech_tpu/data/dataset/librispeech.py``.

Reference: ``src/myrtlespeech/data/dataset/librispeech.py :: LibriSpeech``
(torch Dataset with download+checksum).  This reader consumes the standard
on-disk layout

    <data_dir>/<subset>/<speaker>/<chapter>/<speaker>-<chapter>-<utt>.{flac,wav}
    <data_dir>/<subset>/<speaker>/<chapter>/<speaker>-<chapter>.trans.txt

``LibriSpeechConfig.download=True`` fetches missing subsets from OpenSLR
with MD5 verification (the reference's download+checksum behaviour); on a
host with no network egress the downloader raises a clear, actionable
error — point ``data_dir`` at an existing copy instead.  FLAC decode uses ``soundfile`` when importable;
WAV uses the stdlib.  An index of ``(path, duration, transcript)`` is
built once and cached, enabling duration bucketing and ``max_duration_s``
filtering without touching audio.
"""

from __future__ import annotations

import hashlib
import json
import os
import tarfile
import wave as wave_mod
from typing import List, Optional, Tuple

import numpy as np

from myrtlespeech_tpu_torch.config.schema import LibriSpeechConfig

_OPENSLR_URL = "https://www.openslr.org/resources/12/{subset}.tar.gz"

# Official OpenSLR archive checksums (public constants, same set the
# reference verifies against).
_MD5 = {
    "dev-clean": "42e2234ba48799c1f50f24a7926300a1",
    "dev-other": "c8d0bcc9cca99d4f8b62fcc847357931",
    "test-clean": "32fa31d27d2e1cad72775fee3f4849a9",
    "test-other": "fb5a50374b501bb3bac4815ee91d3135",
    "train-clean-100": "2a93770f6d5c6c964bc36631d331a522",
    "train-clean-360": "c0e676e450a7ff2f54aeade5171606fa",
    "train-other-500": "d1a0fd59409fead2d42a225c130a15bd",
}


def _md5_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def download_subset(subset: str, data_dir: str) -> str:
    """Download + verify + extract one LibriSpeech subset from OpenSLR.

    Returns the subset directory (``<data_dir>/<subset>``).  Idempotent:
    an already-extracted subset is returned as-is; an already-downloaded
    archive is re-verified and re-extracted.  Network failures (including
    hosts with blocked egress) raise a RuntimeError naming the URL so
    the user can fetch the archive out of band.
    """
    dest = os.path.join(data_dir, subset)
    if os.path.isdir(dest):
        return dest
    os.makedirs(data_dir, exist_ok=True)
    url = _OPENSLR_URL.format(subset=subset)
    archive = os.path.join(data_dir, f"{subset}.tar.gz")
    if not os.path.exists(archive):
        import urllib.error
        import urllib.request

        tmp = archive + ".part"
        try:
            with urllib.request.urlopen(url) as r, open(tmp, "wb") as out:
                while True:
                    b = r.read(1 << 20)
                    if not b:
                        break
                    out.write(b)
        except (urllib.error.URLError, OSError) as e:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"could not download {url} ({e}); if this environment has "
                f"no network egress, fetch the archive out of band and "
                f"place it at {archive} (or the extracted tree at {dest})"
            ) from e
        os.replace(tmp, archive)
    want = _MD5.get(subset)
    if want is not None:
        got = _md5_file(archive)
        if got != want:
            raise RuntimeError(
                f"MD5 mismatch for {archive}: got {got}, want {want}; "
                "delete the file and retry")
    with tarfile.open(archive, "r:gz") as tar:
        tar.extractall(data_dir, filter="data")
    # Archives extract to LibriSpeech/<subset>; normalise to
    # <data_dir>/<subset> with a rename (same filesystem).
    extracted = os.path.join(data_dir, "LibriSpeech", subset)
    if os.path.isdir(extracted) and not os.path.isdir(dest):
        os.rename(extracted, dest)
    if not os.path.isdir(dest):
        raise RuntimeError(f"archive {archive} did not contain {subset}")
    return dest


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    with wave_mod.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        raw = f.readframes(n)
        width = f.getsampwidth()
        if width == 2:
            wav = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            wav = np.frombuffer(raw, np.int32).astype(np.float32) / 2 ** 31
        else:
            raise ValueError(f"unsupported sample width {width} in {path}")
        if f.getnchannels() > 1:
            wav = wav.reshape(-1, f.getnchannels()).mean(axis=1)
    return wav, sr


def _read_audio(path: str) -> Tuple[np.ndarray, int]:
    if path.endswith(".wav"):
        return _read_wav(path)
    try:
        import soundfile  # optional; not installed everywhere
    except ImportError as e:
        raise RuntimeError(
            f"reading {path} requires the 'soundfile' package for FLAC; "
            "convert to wav or install soundfile") from e
    wav, sr = soundfile.read(path, dtype="float32")
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    return wav, sr


class LibriSpeech:
    """Map-style dataset of ``(waveform float32 (S,), transcript str)``."""

    def __init__(self, cfg: LibriSpeechConfig):
        self.cfg = cfg
        self.entries: List[Tuple[str, float, str]] = []
        for subset in cfg.subsets:
            root = os.path.join(cfg.data_dir, subset.value)
            if not os.path.isdir(root) and getattr(cfg, "download", False):
                root = download_subset(subset.value, cfg.data_dir)
            if not os.path.isdir(root):
                raise FileNotFoundError(
                    f"LibriSpeech subset dir not found: {root} "
                    "(set LibriSpeechConfig.download=True to fetch from "
                    "OpenSLR, MD5-verified)")
            self.entries.extend(self._index_subset(root))
        if cfg.max_duration_s is not None:
            self.entries = [e for e in self.entries
                            if e[1] <= cfg.max_duration_s]
        self.entries.sort(key=lambda e: e[0])

    def _index_subset(self, root: str) -> List[Tuple[str, float, str]]:
        cache = os.path.join(root, ".myrtlespeech_tpu_index.json")
        if os.path.exists(cache):
            with open(cache) as f:
                return [tuple(e) for e in json.load(f)]
        entries = []
        for dirpath, _dirnames, filenames in os.walk(root):
            for fn in filenames:
                if not fn.endswith(".trans.txt"):
                    continue
                with open(os.path.join(dirpath, fn)) as f:
                    for line in f:
                        utt_id, _, text = line.strip().partition(" ")
                        for ext in (".flac", ".wav"):
                            p = os.path.join(dirpath, utt_id + ext)
                            if os.path.exists(p):
                                dur = self._duration(p)
                                entries.append((p, dur, text.lower()))
                                break
        try:
            with open(cache, "w") as f:
                json.dump(entries, f)
        except OSError:
            pass  # read-only data dir: just skip the cache
        return entries

    @staticmethod
    def _duration(path: str) -> float:
        if path.endswith(".wav"):
            with wave_mod.open(path, "rb") as f:
                return f.getnframes() / f.getframerate()
        try:
            import soundfile
            info = soundfile.info(path)
            return info.frames / info.samplerate
        except ImportError:
            return 0.0  # unknown; bucketing falls back to decode-time length

    def __len__(self) -> int:
        return len(self.entries)

    def duration_samples(self, index: int, sample_rate: int = 16000) -> int:
        return int(self.entries[index][1] * sample_rate)

    def audio_path(self, index: int) -> Optional[str]:
        """Path of the raw audio when the native batch decoder can read it
        directly (``native/audio_io.cc``), else None (FLAC goes through
        the Python/soundfile reader)."""
        path = self.entries[index][0]
        return path if path.endswith(".wav") else None

    def transcript(self, index: int) -> str:
        return self.entries[index][2]

    def __getitem__(self, index: int) -> Tuple[np.ndarray, str]:
        path, _dur, text = self.entries[index]
        wav, _sr = _read_audio(path)
        return wav.astype(np.float32), text
