"""Deterministic fake speech-to-text dataset.

The port's copy of ``myrtlespeech_tpu/data/dataset/fake.py``: the same
``(seed, index)`` gives the same waveform and transcript in both packages.

Reference: ``src/myrtlespeech/data/dataset/fake.py :: FakeDataset`` —
random audio + random label strings within configured ranges, the backbone
of hardware-independent tests and e2e smoke runs.  Samples are generated
lazily and deterministically from ``(seed, index)`` so any worker/host can
materialise any element without coordination (per-host sharding needs no
shared state).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from myrtlespeech_tpu_torch.config.schema import FakeSpeechToTextConfig


class FakeSpeechToText:
    """Map-style dataset of ``(waveform float32 (S,), transcript str)``."""

    def __init__(self, cfg: FakeSpeechToTextConfig):
        self.cfg = cfg

    def __len__(self) -> int:
        return self.cfg.dataset_len

    def duration_samples(self, index: int) -> int:
        """Cheap length probe (for bucketing) without generating audio."""
        rng = np.random.default_rng((self.cfg.seed, index))
        ms = rng.integers(self.cfg.audio_ms.lower, self.cfg.audio_ms.upper + 1)
        return int(ms * self.cfg.sample_rate // 1000)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, str]:
        if not 0 <= index < len(self):
            raise IndexError(index)
        c = self.cfg
        rng = np.random.default_rng((c.seed, index))
        ms = rng.integers(c.audio_ms.lower, c.audio_ms.upper + 1)
        n = int(ms * c.sample_rate // 1000)
        wav = rng.standard_normal(n).astype(np.float32) * 0.1
        label_len = rng.integers(c.label_len.lower, c.label_len.upper + 1)
        syms = rng.choice(list(c.label_symbols), size=label_len)
        return wav, "".join(syms)

    def transcript(self, index: int) -> str:
        """Transcript metadata (multi-host loaders size label pads from
        the global chunk without shipping audio).  The audio draw must
        still advance the RNG so the stream matches ``__getitem__``."""
        return self[index][1]
