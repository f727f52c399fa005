"""The one traffic generator: batches of seeded noise with their lengths and
labels, from a traffic file's parameters.

Every batch holds the same set of rows: ``B`` lengths evenly spread over
``[seconds_min, seconds_max]`` (a row at the middle of each stratum), each
paired with one of ``B`` label rates evenly spread over
``[labels_per_second_min, labels_per_second_max]`` by a pairing fixed once
(drawn from seed 0), as speakers' rates differ.  The seed only chooses
which row of a batch gets which (length, rate) pair, the noise and the
labels.  So every seed and every batch carries the same real audio and the
same label count, and a window's work does not depend on the seed.  Rows
are padded to ``pad_seconds`` (the bucket's cap), labels to ``label_cap``.
Labels are uniform over the non-blank symbols, ``floor(rate * seconds)`` a
row, at most ``label_cap``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

NOISE_SCALE = 0.1


def row_seconds(traffic: dict, batch: int) -> np.ndarray:
    lo, hi = traffic["seconds_min"], traffic["seconds_max"]
    return lo + (hi - lo) * (np.arange(batch) + 0.5) / batch


def row_rates(traffic: dict, batch: int) -> np.ndarray:
    """Each length stratum's label rate, paired once and for all."""
    lo = traffic["labels_per_second_min"]
    hi = traffic["labels_per_second_max"]
    rates = lo + (hi - lo) * (np.arange(batch) + 0.5) / batch
    return rates[np.random.default_rng(0).permutation(batch)]


def make_batches(traffic: dict, batch: int, seed: int, config: dict
                 ) -> List[Dict[str, np.ndarray]]:
    """``distinct_batches`` host batches: ``wav (B, S)`` float32,
    ``wav_lens (B,)`` int32 and, where the traffic has labels, ``labels
    (B, label_cap)`` and ``label_lens (B,)`` int32."""
    sr = config["features"]["sample_rate"]
    rng = np.random.default_rng(seed)
    pad = int(round(traffic["pad_seconds"] * sr))
    secs = row_seconds(traffic, batch)
    labelled = "labels_per_second_min" in traffic
    rates = row_rates(traffic, batch) if labelled else None
    n_symbols = config["vocab_size"]
    blank = config["blank_index"]
    symbols = np.array([s for s in range(n_symbols) if s != blank],
                       np.int32)
    out = []
    for _ in range(traffic["distinct_batches"]):
        order = rng.permutation(batch)
        s = secs[order]
        lens = np.minimum(np.round(s * sr).astype(np.int32), pad)
        wav = rng.standard_normal((batch, pad), dtype=np.float32)
        wav *= NOISE_SCALE
        wav *= np.arange(pad)[None, :] < lens[:, None]
        b = {"wav": wav, "wav_lens": lens}
        if labelled:
            cap = traffic["label_cap"]
            ulen = np.minimum(np.floor(rates[order] * s).astype(np.int32),
                              cap)
            labels = symbols[rng.integers(0, len(symbols), (batch, cap))]
            labels[np.arange(cap)[None, :] >= ulen[:, None]] = 0
            b["labels"] = labels.astype(np.int32)
            b["label_lens"] = ulen
        out.append(b)
    return out


def audio_seconds(batch: Dict[str, np.ndarray], config: dict) -> float:
    """Real (unpadded) seconds of audio in a batch."""
    return float(batch["wav_lens"].sum()) / config["features"]["sample_rate"]
