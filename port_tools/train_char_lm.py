"""Estimate a char-bigram LM (and a word LM) for the port's CTC beam decoder.

The port's counterpart of ``tools/train_char_lm.py``: it writes the ``(V+1,
V)`` log-prob .npy that ``CTCBeamDecoderConfig.lm_bigram_path`` reads and,
with ``--word-lm-out``, the word LM hash tables (.npz) that
``CTCBeamDecoderConfig.word_lm_path`` reads (``decoding/lm.py``), from a
config's train transcripts or from a text file.  The files are byte-equal to
the JAX tool's for the same config and text.  It needs no card.

Usage:
  python port_tools/train_char_lm.py \\
      --config myrtlespeech_tpu_torch/configs/deep_speech_2_en.py \\
      --out /tmp/librispeech_char_lm.npy            # from the train dataset
  python port_tools/train_char_lm.py --config ... --text corpus.txt --out lm.npy
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True,
                   help=".py (or .json) task config of the port "
                        "(provides alphabet + train dataset)")
    p.add_argument("--text", default=None,
                   help="optional text file (one transcript per line); "
                        "defaults to the config's train dataset transcripts")
    p.add_argument("--out", default=None, help="char-bigram output .npy")
    p.add_argument("--word-lm-out", default=None,
                   help="also/instead estimate a word-unigram LM hash "
                        "table (.npz, CTCBeamDecoderConfig.word_lm_path)")
    p.add_argument("--separator", default=" ",
                   help="word separator symbol for --word-lm-out")
    p.add_argument("--smoothing", type=float, default=1.0)
    p.add_argument("--word-lm-order", type=int, default=1, choices=(1, 2),
                   help="word LM order: 2 adds a bigram table with "
                        "stupid backoff to the unigram")
    args = p.parse_args(argv)

    from myrtlespeech_tpu_torch.builders.build import (build_alphabet,
                                                       build_dataset,
                                                       vocab_size)
    from myrtlespeech_tpu_torch.config.serde import load
    from myrtlespeech_tpu_torch.decoding.lm import (estimate_bigram_lm,
                                                    estimate_word_lm,
                                                    save_bigram_lm,
                                                    save_word_lm)

    cfg = load(args.config)
    stt = cfg.speech_to_text
    alphabet = build_alphabet(stt)

    if args.text is not None:
        with open(args.text) as f:
            transcripts = [line.rstrip("\n") for line in f]
    else:
        ds = build_dataset(cfg.train_dataset)
        transcripts = [ds[i][1] for i in range(len(ds))]

    if args.out is None and args.word_lm_out is None:
        p.error("need --out and/or --word-lm-out")
    if args.out is not None:
        lm = estimate_bigram_lm(
            transcripts, alphabet, smoothing=args.smoothing,
            blank_index=stt.loss.blank_index, vocab_size=vocab_size(stt))
        save_bigram_lm(args.out, lm)
        print(f"wrote {lm.shape} char-bigram LM "
              f"({len(transcripts)} transcripts) to {args.out}",
              file=sys.stderr)
    if args.word_lm_out is not None:
        wlm = estimate_word_lm(transcripts, alphabet,
                               separator=args.separator,
                               smoothing=args.smoothing,
                               order=args.word_lm_order)
        save_word_lm(args.word_lm_out, wlm)
        n = int((wlm.key1 != 0).sum() + (wlm.key2 != 0).sum() -
                ((wlm.key1 != 0) & (wlm.key2 != 0)).sum())
        print(f"wrote word LM ({n} words, table {wlm.key1.shape[0]}) "
              f"to {args.word_lm_out}", file=sys.stderr)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
