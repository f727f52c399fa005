"""Audio features: framing, power STFT, log-mel filterbank, standardize.

Port of ``myrtlespeech_tpu/ops/features.py:28-191``:

  waveform (B, S) -> frames (B, T, n_fft) -> |rFFT|^2 -> mel (matmul)
  -> log -> features (B, T, n_mels)

Frame counts follow torchaudio's ``center=True`` convention
(``T = S // hop + 1``).  The filterbank and window are built in numpy, as in
the JAX package, and moved to the input's device.  The transform is
``torch.fft.rfft`` on every device (the JAX package's CPU path; its TPU path
wrote the DFT as two matmuls to reach the MXU).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from myrtlespeech_tpu_torch.ops.masking import mask_sequence, sequence_mask


def hz_to_mel(f):
    """HTK mel scale (torchaudio's default ``mel_scale='htk'``)."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                   f_min: float = 0.0, f_max: Optional[float] = None
                   ) -> np.ndarray:
    """Triangular mel filterbank ``(n_fft // 2 + 1, n_mels)`` (HTK, no norm).

    Matches torchaudio.functional.melscale_fbanks.
    """
    f_max = f_max if f_max is not None else sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up)).astype(np.float32)
    fb.setflags(write=False)
    return fb


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window zero-padded symmetrically to ``n_fft``."""
    w = 0.5 - 0.5 * np.cos(2.0 * math.pi * np.arange(win_length) / win_length)
    pad = n_fft - win_length
    left = pad // 2
    out = np.zeros((n_fft,), dtype=np.float32)
    out[left:left + win_length] = w
    out.setflags(write=False)
    return out


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """``(B, S) -> (B, T, n_fft)`` frames with center reflect padding.

    The reflect padding is one index map into ``x`` (period ``2(S-1)``), so
    it also holds where the pad is longer than the signal, as ``jnp.pad``'s
    reflect mode does.
    """
    B, S = x.shape
    pad = n_fft // 2
    n_frames = S // hop + 1
    dev = x.device
    pos = (torch.arange(n_frames, device=dev) * hop)[:, None] \
        + torch.arange(n_fft, device=dev)[None, :] - pad
    if S > 1:
        period = 2 * (S - 1)
        pos = torch.remainder(pos, period)
        pos = torch.where(pos >= S, period - pos, pos)
    else:
        pos = torch.zeros_like(pos)
    return x[:, pos]


def stft_power(x: torch.Tensor, n_fft: int, hop: int,
               win_length: int) -> torch.Tensor:
    """Power spectrogram ``(B, S) -> (B, T, n_fft//2+1)`` (fp32)."""
    frames = frame_signal(x.float(), n_fft, hop)
    win = torch.from_numpy(hann_window(win_length, n_fft).copy()).to(x.device)
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def num_frames(sample_lens, hop: int):
    """Frame-level lengths from sample-level lengths (center=True)."""
    return sample_lens // hop + 1


def log_mel_spectrogram(x: torch.Tensor, sample_lens: torch.Tensor, *,
                        sample_rate: int = 16000, n_fft: int = 512,
                        win_length: int = 400, hop_length: int = 160,
                        n_mels: int = 80, eps: float = 1e-10):
    """Batched log-mel features.

    ``x``: ``(B, S)`` waveform (computed in fp32); ``sample_lens``: ``(B,)``.
    Returns ``(features (B, T, n_mels) fp32, frame_lens (B,) int32)``.
    Samples past each length are zeroed before framing, so features are a
    function of the valid samples only.
    """
    x = mask_sequence(x.float(), sample_lens)
    power = stft_power(x, n_fft, hop_length, win_length)
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate).copy())
    mel = power @ fb.to(x.device)
    feats = torch.log(mel + eps)
    return feats, num_frames(sample_lens, hop_length).to(torch.int32)


def standardize(feats: torch.Tensor, frame_lens: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-utterance mean/variance normalisation over valid frames only."""
    B, T, F = feats.shape
    mask = sequence_mask(frame_lens, T, feats.dtype)[:, :, None]
    n = torch.clamp(frame_lens.to(feats.dtype), min=1.0)[:, None, None] * F
    mean = torch.sum(feats * mask, dim=(1, 2), keepdim=True) / n
    var = torch.sum(((feats - mean) * mask) ** 2, dim=(1, 2),
                    keepdim=True) / n
    return (feats - mean) * torch.rsqrt(var + eps) * mask
