"""Serving entry point: waveforms -> transcripts.

Port of the decode half of ``myrtlespeech_tpu/run/train.py::eval_step_body``
(``:278-326``), under ``torch.inference_mode()``:

- an RNN-T: features -> ``RNNT.encode`` -> ``joint_project_f`` -> the
  config's greedy or beam decoder (``decoding/rnnt_{greedy,beam}.py``);
- a CTC model (DeepSpeech1, DeepSpeech2 or an encoder-decoder): features
  -> the model's logits -> the config's CTC decoder (greedy, or prefix beam
  search with its LMs).

Every LSTM layer runs through K1 (``ops/cuda/lstm_kernel.py``) on the card,
a GRU, vanilla or hard-LSTM layer through its PyTorch recurrence
(``ops/rnn.py``); the decoders are PyTorch on the card, and the only copy
to the host is the transcript's at the end.  An RNN-T whose prediction net
is a GRU or a vanilla RNN has no decoder (``RNNT.check_decodable``).

    python -m myrtlespeech_tpu_torch.run.infer --config rnn_t_en --batch 32 --seconds 5
    python -m myrtlespeech_tpu_torch.run.infer --config rnn_t_960_beam --batch 32 --seconds 5
    python -m myrtlespeech_tpu_torch.run.infer --config deep_speech_2_en --batch 32 --seconds 16.7
    python -m myrtlespeech_tpu_torch.run.infer --config deep_speech_1_en --batch 32 --seconds 16.7

runs a config of ``myrtlespeech_tpu_torch/configs`` with seeded random
weights on seeded random audio and prints one JSON line of timings.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import time
from typing import List, Mapping, Optional

import numpy as np
import torch

from myrtlespeech_tpu_torch.builders.build import (build_decoder, build_model,
                                                   build_preprocess,
                                                   is_transducer,
                                                   preprocess_out_features,
                                                   random_params)
from myrtlespeech_tpu_torch.config import schema as S
from myrtlespeech_tpu_torch.data.alphabet import Alphabet
from myrtlespeech_tpu_torch.ops.cuda.lstm_kernel import lstm_fwd


def resolve_device(device: str = "cuda") -> torch.device:
    """``torch.device(device)``; raises if it is a CUDA device and there is
    no card, so that a run never lands on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "on the CPU")
    return dev


@dataclasses.dataclass
class Transcription:
    tokens: torch.Tensor  # (B, max_output_len or T') int32, on the device
    lengths: torch.Tensor  # (B,) int32
    texts: List[str]


class Transcriber:
    """A task config with its weights, ready to transcribe batches."""

    def __init__(self, task_config: S.TaskConfig,
                 params: Mapping[str, torch.Tensor], device: torch.device):
        stt = task_config.speech_to_text
        self.device = device
        self.dtype = getattr(torch, task_config.train_config.compute_dtype)
        self.alphabet = Alphabet(stt.alphabet)
        self.preprocess = build_preprocess(stt.pre_process_steps)
        self.model = build_model(
            stt, self.dtype, preprocess_out_features(stt.pre_process_steps))
        self.model.load_state_dict(params)
        self.model.to(device).eval()
        self.transducer = is_transducer(stt)
        self.decode = build_decoder(stt, self.model)

    def outputs(self, feats, flens):
        """What the decoder reads, with its lengths: the encoder's output
        (RNN-T) or the logits (CTC)."""
        if self.transducer:
            return self.model.encode(feats, flens)
        return self.model(feats, flens, False)

    def decode_outputs(self, x, x_lens, max_output_len: int = 200):
        """``(tokens, lengths)`` from :meth:`outputs`.  ``max_output_len``
        caps an RNN-T's symbols; a CTC decoder returns up to one symbol a
        frame, as the JAX package's eval step decodes it."""
        if self.transducer:
            return self.decode(x, x_lens, max_output_len=max_output_len)
        return self.decode(x, x_lens)

    def transcribe(self, wav, wav_lens,
                   max_output_len: int = 200) -> Transcription:
        """``wav (B, S)`` float samples, ``wav_lens (B,)`` valid counts.

        ``max_output_len`` caps an RNN-T's symbols only: a CTC model's
        transcript is never capped (up to one symbol a frame)."""
        with torch.inference_mode():
            wav = torch.as_tensor(wav, dtype=torch.float32,
                                  device=self.device)
            wav_lens = torch.as_tensor(wav_lens, device=self.device)
            feats, flens = self.preprocess(wav, wav_lens)
            tokens, lens = self.decode_outputs(*self.outputs(feats, flens),
                                               max_output_len=max_output_len)
        toks, ls = tokens.cpu().numpy(), lens.cpu().numpy()
        texts = [self.alphabet.get_symbols(toks[i, :ls[i]])
                 for i in range(len(ls))]
        return Transcription(tokens=tokens, lengths=lens, texts=texts)


def build_transcriber(task_config: S.TaskConfig,
                      params: Mapping[str, torch.Tensor],
                      device: str = "cuda") -> Transcriber:
    """Build a :class:`Transcriber` on ``device`` (the card by default).

    ``params`` is the port's state_dict, e.g. from ``weights.params_from_npz``
    or :func:`builders.build.random_params`.  Float32 products run in full
    float32 on the card: TF32 is switched off for matmuls and cuDNN.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return Transcriber(task_config, params, dev)


def load_config(name: str) -> S.TaskConfig:
    """``task_config`` of ``myrtlespeech_tpu_torch/configs/<name>.py``."""
    return importlib.import_module(
        f"myrtlespeech_tpu_torch.configs.{name}").task_config


def pad_waveforms(waves: List[np.ndarray]):
    """Zero-pad 1-d waveforms to the longest: ``(wav (B, S) float32,
    wav_lens (B,) int32)``."""
    lens = np.asarray([len(w) for w in waves], dtype=np.int32)
    wav = np.zeros((len(waves), int(lens.max())), dtype=np.float32)
    for i, w in enumerate(waves):
        wav[i, :len(w)] = w
    return wav, lens


def random_audio(batch: int, seconds: float, sample_rate: int = 16000,
                 seed: int = 0):
    """Seeded noise waveforms ``(batch, samples)`` float32 at full length."""
    n = int(seconds * sample_rate)
    rng = np.random.default_rng(seed)
    wav = (0.1 * rng.standard_normal((batch, n))).astype(np.float32)
    return wav, np.full((batch,), n, dtype=np.int32)


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="rnn_t_en")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    tr = build_transcriber(cfg, random_params(cfg, args.seed), args.device)
    wav, lens = random_audio(args.batch, args.seconds, seed=args.seed)
    tr.transcribe(wav, lens)  # warm-up: builds the kernel on first use
    launches0 = lstm_fwd.launches
    times = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        out = tr.transcribe(wav, lens)  # ends in a copy to the host
        times.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(times))
    print(json.dumps({
        "config": args.config, "device": str(tr.device),
        "device_name": (torch.cuda.get_device_name(tr.device)
                        if tr.device.type == "cuda" else "cpu"),
        "batch": args.batch, "seconds": args.seconds,
        "ms_per_batch": ms,
        "audio_s_per_s": args.batch * args.seconds / (ms / 1e3),
        "k1_launches_per_batch": (lstm_fwd.launches - launches0) // args.runs,
        "token_lens": out.lengths.cpu().tolist()}))


if __name__ == "__main__":
    main()
