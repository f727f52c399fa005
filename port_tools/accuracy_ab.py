"""Decoder-ordering A/B on a trained checkpoint of the port.

The port's counterpart of ``tools/accuracy_ab.py``: it scores ONE
checkpoint (a ``run/checkpoint.py::CheckpointManager`` directory, e.g. the
CLI's ``--checkpoint_dir``) under a family of decoder configurations, so the
expected accuracy orderings are measurable on the hard synthetic corpus:
beam > greedy, LM-alpha > no-LM, wider beam >= narrow.  The CTC family's
LMs (char bigram, word unigram, word bigram) are estimated from the train
transcripts.  Each variant is one ``fit(..., eval_only=True)`` pass with the
config's ``post_process`` swapped; it prints a JSON line a variant, then a
table.  It runs on the card unless ``--device cpu``.

Usage:
  python port_tools/accuracy_ab.py \\
      --config myrtlespeech_tpu_torch/configs/synthetic_hard_ctc.py \\
      --checkpoint_dir /tmp/acc/ctc_ckpt --family ctc --eval_noise 0.5
  python port_tools/accuracy_ab.py \\
      --config myrtlespeech_tpu_torch/configs/synthetic_medium_rnnt.py \\
      --checkpoint_dir /tmp/acc/rnnt_ckpt --family rnnt
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eval_with_decoder(cfg, post_process, ckpt_dir, device="cuda"):
    """Build the task with ``post_process`` swapped in, restore the
    checkpoint into it, and run one decoding eval pass."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.run import callbacks as C
    from myrtlespeech_tpu_torch.run.checkpoint import CheckpointManager
    from myrtlespeech_tpu_torch.run.cli import _restore_state
    from myrtlespeech_tpu_torch.run.train import fit

    cfg = S.replace(cfg, speech_to_text=S.replace(
        cfg.speech_to_text, post_process=post_process))
    steps_per_epoch = max(1, math.ceil(
        cfg.train_dataset.dataset_len / cfg.train_config.batch_size))
    task = build_task(cfg, steps_per_epoch=steps_per_epoch)
    mgr = CheckpointManager(ckpt_dir)
    if mgr.latest_step() is None:
        raise SystemExit(f"no checkpoint in {ckpt_dir}")
    state, _, _ = _restore_state(task, mgr, device)
    handler = fit(task, callbacks=[C.ReportMeanBatchLoss(),
                                   C.ReportDecoderWER(task.alphabet)],
                  initial_state=state, eval_only=True, device=device)
    r = handler.state.get("reports", {})
    return {"wer": r.get("wer"), "cer": r.get("cer"),
            "eval_loss": r.get("eval_mean_loss"),
            "step": int(state.step)}


def _lm_paths(cfg, out_dir):
    """Estimate char-bigram + word-unigram LMs from the TRAIN transcripts."""
    from myrtlespeech_tpu_torch.builders.build import (build_alphabet,
                                                       build_dataset)
    from myrtlespeech_tpu_torch.decoding.lm import (estimate_bigram_lm,
                                                    estimate_word_lm,
                                                    save_bigram_lm,
                                                    save_word_lm)

    alphabet = build_alphabet(cfg.speech_to_text)
    ds = build_dataset(cfg.train_dataset)
    if hasattr(ds, "transcript"):  # text without rendering the audio
        texts = [ds.transcript(i) for i in range(len(ds))]
    else:
        texts = [ds[i][1] for i in range(len(ds))]
    bigram = os.path.join(out_dir, "char_bigram.npy")
    word = os.path.join(out_dir, "word_lm.npz")
    word2 = os.path.join(out_dir, "word_lm_bigram.npz")
    save_bigram_lm(bigram, estimate_bigram_lm(texts, alphabet))
    save_word_lm(word, estimate_word_lm(texts, alphabet, separator=" "))
    save_word_lm(word2, estimate_word_lm(texts, alphabet, separator=" ",
                                         order=2))
    return bigram, word, word2


def variants(cfg, family, beam_width=8, lm_alpha=0.3, word_lm_alpha=0.3,
             lm_dir=None):
    """``[(name, post_process)]``: the JAX tool's five CTC decoders (greedy,
    beam, beam with the char bigram, with the word unigram LM, with the word
    bigram LM; the LMs estimated into ``lm_dir``) or its three RNN-T ones
    (greedy, beam W=2, beam W=``beam_width``)."""
    from myrtlespeech_tpu_torch.config import schema as S

    W = beam_width
    base_beam = cfg.speech_to_text.post_process
    if family == "ctc":
        if not isinstance(base_beam, S.CTCBeamDecoderConfig):
            raise ValueError(f"the ctc family needs a CTC beam config, not "
                             f"{base_beam}")
        bigram, word, word2 = _lm_paths(cfg, lm_dir)
        no_lm = S.replace(base_beam, beam_width=W, lm_alpha=None,
                          lm_bigram_path=None, word_lm_path=None,
                          word_lm_alpha=None, word_count_beta=None)
        return [
            ("greedy", S.CTCGreedyDecoderConfig(
                blank_index=base_beam.blank_index)),
            (f"beam W={W}", no_lm),
            (f"beam W={W} + char-bigram a={lm_alpha}",
             S.replace(no_lm, lm_alpha=lm_alpha, lm_bigram_path=bigram)),
            (f"beam W={W} + word-LM a={word_lm_alpha}",
             S.replace(no_lm, word_lm_path=word,
                       word_lm_alpha=word_lm_alpha, word_count_beta=0.5)),
            (f"beam W={W} + word-BIGRAM-LM a={word_lm_alpha}",
             S.replace(no_lm, word_lm_path=word2,
                       word_lm_alpha=word_lm_alpha, word_count_beta=0.5)),
        ]
    if not isinstance(base_beam, S.RNNTBeamDecoderConfig):
        raise ValueError(f"the rnnt family needs an RNN-T beam config, not "
                         f"{base_beam}")
    return [
        ("greedy", S.RNNTGreedyDecoderConfig(
            blank_index=base_beam.blank_index,
            max_symbols_per_step=base_beam.max_symbols_per_step)),
        ("beam W=2", S.replace(base_beam, beam_width=2)),
        (f"beam W={W}", S.replace(base_beam, beam_width=W)),
    ]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--family", choices=["ctc", "rnnt"], required=True)
    p.add_argument("--beam_width", type=int, default=8)
    p.add_argument("--lm_alpha", type=float, default=0.3)
    p.add_argument("--word_lm_alpha", type=float, default=0.3)
    p.add_argument("--eval_noise", type=float, default=None,
                   help="override eval noise_level (score the checkpoint "
                        "under a harder, unseen condition so orderings "
                        "are measurable when held-out WER has dropped "
                        "below the 5%% band)")
    p.add_argument("--eval_len", type=int, default=None,
                   help="override eval dataset_len")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    args = p.parse_args(argv)

    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.config.serde import load

    cfg = load(args.config)
    if args.eval_noise is not None or args.eval_len is not None:
        kw = {}
        if args.eval_noise is not None:
            kw["noise_level"] = args.eval_noise
        if args.eval_len is not None:
            kw["dataset_len"] = args.eval_len
        cfg = S.replace(cfg, eval_dataset=S.replace(cfg.eval_dataset, **kw))
    results = {}
    with tempfile.TemporaryDirectory(prefix="myrtle_lm_") as lm_dir:
        for name, pp in variants(cfg, args.family, args.beam_width,
                                 args.lm_alpha, args.word_lm_alpha, lm_dir):
            results[name] = _eval_with_decoder(cfg, pp, args.checkpoint_dir,
                                               args.device)
            print(json.dumps({"variant": name, **results[name]}), flush=True)
    print("\n== decoder A/B table ==")
    for name, r in results.items():
        print(f"{name:42s} WER {r['wer']:.4f}  CER {r['cer']:.4f}")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
