"""Convergence check of the port: overfit a tiny task until WER collapses.

The port's counterpart of ``tools/convergence_check.py``.  It shows that the
whole learning pipeline (features -> model -> loss -> Adam -> decode -> WER)
optimizes end to end: the 64 fixed random utterances of ``ctc_tiny_fake``
(or, with ``--model rnnt``, of a tiny RNN-T task on the same kind of fake
data) are memorized to near-zero WER.

Every utterance is cut to one audio bucket (500-501 ms), so every batch has
one shape; the batches are made once and replayed each epoch through the
port's train step, with Adam at 2e-3.  Each epoch reads its mean loss on
the host once (the JAX tool runs its epochs in one jitted ``lax.scan``).
One decoding pass follows (``make_eval_step``, ``max_output_len=32``); it
prints the losses, WER and CER as JSON and fails unless WER < 0.5.  It runs
on the card unless ``--device cpu``.

Usage: python port_tools/convergence_check.py [--epochs 120] [--model rnnt]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHUNK = 30  # epochs between progress lines, as the JAX tool's scans


def tiny_rnnt_config(batch_size: int = 8):
    """The port's copy of ``__graft_entry__.py::_tiny_rnnt_task``'s config:
    a small RNN-T (flagship model family) on the fake dataset."""
    from myrtlespeech_tpu_torch.config.schema import (
        Activation, AdamConfig, FakeSpeechToTextConfig, FullyConnectedConfig,
        IntRange, MFCCConfig, PreProcessStepConfig, RNNConfig, RNNTConfig,
        RNNTEncoderConfig, RNNTGreedyDecoderConfig, RNNTJointNetConfig,
        RNNTLossConfig, RNNTPredictNetConfig, SpeechToTextConfig,
        StandardizeConfig, TaskConfig, TrainConfig,
    )

    return TaskConfig(
        speech_to_text=SpeechToTextConfig(
            alphabet="_ abcdefghijklmnopqrstuvwxyz'",
            pre_process_steps=(
                PreProcessStepConfig(MFCCConfig(n_mels=64,
                                                log_mel_only=True)),
                PreProcessStepConfig(StandardizeConfig()),
            ),
            model=RNNTConfig(
                encoder=RNNTEncoderConfig(
                    rnn1=RNNConfig(hidden_size=256, num_layers=1,
                                   forget_gate_bias=1.0),
                    time_reduction_factor=2,
                    rnn2=RNNConfig(hidden_size=256, num_layers=1,
                                   forget_gate_bias=1.0)),
                prediction=RNNTPredictNetConfig(
                    embedding_dim=128,
                    rnn=RNNConfig(hidden_size=128, num_layers=1)),
                joint=RNNTJointNetConfig(
                    activation=Activation.RELU,
                    fc=FullyConnectedConfig(num_hidden_layers=1,
                                            hidden_size=256,
                                            activation=Activation.RELU)),
            ),
            loss=RNNTLossConfig(blank_index=0),
            post_process=RNNTGreedyDecoderConfig(blank_index=0),
        ),
        train_config=TrainConfig(batch_size=batch_size,
                                 optimizer=AdamConfig(learning_rate=3e-4),
                                 grad_clip_norm=5.0),
        train_dataset=FakeSpeechToTextConfig(
            dataset_len=batch_size * 4, audio_ms=IntRange(300, 500),
            label_symbols="abc ", label_len=IntRange(1, 8)),
    )


def task_config(model: str):
    """The check's config before :func:`make_batches` cuts it."""
    if model == "ctc":
        from myrtlespeech_tpu_torch.configs.ctc_tiny_fake import task_config
        return task_config
    return tiny_rnnt_config(batch_size=8)


def make_batches(base):
    """``(task, batches, texts)``: ``base`` with one audio bucket (500-501
    ms), no eval set and Adam at 2e-3, built for 8 steps an epoch; its train
    set in loader order without shuffling, each batch's arrays (no ``texts``
    or ``n_real``) as numpy, and every row's transcript in order."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.data.batch import BucketedLoader

    cfg = S.replace(
        base,
        train_dataset=S.replace(base.train_dataset,
                                audio_ms=S.IntRange(500, 501)),
        eval_dataset=None,
        train_config=S.replace(base.train_config,
                               optimizer=S.AdamConfig(learning_rate=2e-3)),
    )
    task = build_task(cfg, steps_per_epoch=8)
    loader = BucketedLoader(task.train_dataset, task.alphabet,
                            cfg.train_config.batch_size, shuffle=False)
    batches, texts = [], []
    for b in loader:
        texts.extend(b["texts"])
        batches.append({k: v for k, v in b.items()
                        if k not in ("texts", "n_real")})
    return task, batches, texts


def train_epochs(task, state, batches, n_epochs: int):
    """``n_epochs`` passes of the train step over ``batches`` (tensors on
    the model's device); returns each epoch's mean loss, read on the host
    once an epoch."""
    import torch

    from myrtlespeech_tpu_torch.run.train import make_train_step

    step = make_train_step(task)
    means = []
    for _ in range(n_epochs):
        total = torch.zeros((), device=batches[0]["wav"].device)
        for batch in batches:
            state, m = step(state, batch)
            total = total + m["loss"].float()
        means.append(float(total) / len(batches))
    return state, means


def evaluate(task, state, batches, texts):
    """One decoding pass over ``batches``: ``(wer, cer, refs, hyps)``."""
    from myrtlespeech_tpu_torch.decoding.wer import cer, wer
    from myrtlespeech_tpu_torch.run.train import make_eval_step

    eval_step = make_eval_step(task, decode=True, max_output_len=32)
    refs, hyps = [], []
    for i, batch in enumerate(batches):
        m = eval_step(state, batch)
        toks = m["decoded_tokens"].cpu().numpy()
        lens = m["decoded_lens"].cpu().numpy()
        B = toks.shape[0]
        for j in range(B):
            refs.append(texts[i * B + j])
            hyps.append(task.alphabet.get_symbols(toks[j, :lens[j]]))
    return wer(refs, hyps), cer(refs, hyps), refs, hyps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--model", choices=["ctc", "rnnt"], default="ctc")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    args = p.parse_args(argv)

    from myrtlespeech_tpu_torch.run.train import init_state, to_device

    task, batches, texts = make_batches(task_config(args.model))
    state = init_state(task, seed=0, device=args.device)
    dev = next(state.model.parameters()).device
    batches = [to_device(b, dev) for b in batches]

    losses = []
    for k in range(0, args.epochs, CHUNK):
        n = min(CHUNK, args.epochs - k)
        state, means = train_epochs(task, state, batches, n)
        losses.extend(means)
        print(f"epochs {k}-{k + n}: mean loss {means[-1]:.3f}", flush=True)

    w, c, refs, hyps = evaluate(task, state, batches, texts)
    print(json.dumps({"model": args.model, "device": str(dev),
                      "first_loss": losses[0], "final_loss": losses[-1],
                      "wer": w, "cer": c,
                      "sample": {"ref": refs[0], "hyp": hyps[0]}}))
    if not w < 0.5:
        raise SystemExit(f"pipeline failed to learn (wer={w})")
    print("CONVERGED")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
