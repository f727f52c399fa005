"""Word/character error rates: the port's copy of ``decoding/wer.py``.

Levenshtein distance with the classic two-row DP.  A batch of distances
goes through the C++ library of ``myrtlespeech_tpu_torch/native`` when it
builds (as in the JAX package); this pure-Python path is the fallback for a
host without a compiler and the oracle for it.
"""

from __future__ import annotations

import subprocess
from typing import List, Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance between two token sequences."""
    if len(ref) < len(hyp):
        ref, hyp = hyp, ref
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (r != h))
        prev = cur
    return prev[-1]


def error_counts(refs: List[Sequence], hyps: List[Sequence]
                 ) -> Tuple[int, int]:
    """``(sum of edit distances, total reference length)``: the sufficient
    statistics of an error rate."""
    try:
        from myrtlespeech_tpu_torch.native import edit_distance_batch
        dists = edit_distance_batch(refs, hyps)
    except (OSError, subprocess.CalledProcessError):
        dists = [edit_distance(r, h) for r, h in zip(refs, hyps)]
    return sum(dists), sum(len(r) for r in refs)


def error_rate(refs: List[Sequence], hyps: List[Sequence]) -> float:
    """Sum of edit distances / total reference length (as a fraction)."""
    dist, total = error_counts(refs, hyps)
    return dist / max(total, 1)


def wer(ref_transcripts: List[str], hyp_transcripts: List[str]) -> float:
    """Word error rate over a corpus (split on whitespace)."""
    return error_rate([r.split() for r in ref_transcripts],
                      [h.split() for h in hyp_transcripts])


def cer(ref_transcripts: List[str], hyp_transcripts: List[str]) -> float:
    """Character error rate over a corpus."""
    return error_rate([list(r) for r in ref_transcripts],
                      [list(h) for h in hyp_transcripts])


def wer_counts(ref_transcripts: List[str], hyp_transcripts: List[str]
               ) -> Tuple[int, int]:
    """``(word edits, reference words)``."""
    return error_counts([r.split() for r in ref_transcripts],
                        [h.split() for h in hyp_transcripts])


def cer_counts(ref_transcripts: List[str], hyp_transcripts: List[str]
               ) -> Tuple[int, int]:
    """``(character edits, reference characters)``."""
    return error_counts([list(r) for r in ref_transcripts],
                        [list(h) for h in hyp_transcripts])
