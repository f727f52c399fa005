"""Decode-path profiler of the port: RNN-T greedy and beam, CTC beam.

The port's counterpart of ``tools/profile_decode.py``.  It encodes a batch
of ``--batch`` x ``--seconds`` of seeded noise with the port's ``rnn_t_en``
(seeded random weights), then times the port's decoders on the projected
encoder output: RNN-T greedy (8 symbols a frame, 128 out), RNN-T beam (W
``--beam``, 4 symbols a frame, ``--expand-topk``, with ``--prune-ab`` the
expansion pruning on and off and with ``--spec-ab`` speculative frame
blocks of ``--spec-frames`` and none), then the CTC prefix beam (W=16) on
random logits of the encoder's length, alone and with a word bigram LM of
4,096-slot random tables.  Each is timed once after a warm-up call by CUDA
events around the call (the decoders read their loop flags on the host, so
this is the call's wall time on the card).  ``--blank-bias`` adds to the
blank logit: random weights emit at the symbol cap every frame, and a
positive bias gives a trained model's rate of emissions.

Usage: python port_tools/profile_decode.py [--batch 8] [--seconds 5]
       [--beam 8] [--expand-topk K] [--prune-ab] [--spec-ab] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--beam", type=int, default=8)
    p.add_argument("--expand-topk", type=int, default=None,
                   help="beam expansion top-k pruning (None = full V)")
    p.add_argument("--prune-ab", action="store_true",
                   help="A/B the Graves-style expansion pruning")
    p.add_argument("--spec-ab", action="store_true",
                   help="A/B speculative frame-blocking (F=8 vs off)")
    p.add_argument("--spec-frames", type=int, default=8)
    p.add_argument("--blank-bias", type=float, default=0.0,
                   help="add to the blank logit: untrained weights emit at "
                        "the max-symbols cap EVERY frame (worst case for "
                        "pruning/speculation); a positive bias reproduces "
                        "trained-posterior behaviour (~1 emission per 3-5 "
                        "frames at +4)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from myrtlespeech_tpu_torch.builders.build import (
        build_rnnt_decode_helpers, build_task)
    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.configs.rnn_t_en import task_config
    from myrtlespeech_tpu_torch.decoding.ctc_beam import (WordLMTensors,
                                                          ctc_beam_decode)
    from myrtlespeech_tpu_torch.decoding.lm import WordLM
    from myrtlespeech_tpu_torch.decoding.rnnt_beam import rnnt_beam_decode
    from myrtlespeech_tpu_torch.decoding.rnnt_greedy import \
        rnnt_greedy_decode
    from myrtlespeech_tpu_torch.run.train import (example_batch, init_state,
                                                  to_device)

    from port_tools.tool_common import device_of, median_ms, print_card

    dev = device_of(args.device)
    print_card(dev)
    B = args.batch
    cfg = S.replace(
        task_config,
        train_dataset=S.FakeSpeechToTextConfig(dataset_len=8),
        eval_dataset=None,
        train_config=S.replace(task_config.train_config, batch_size=B))
    task = build_task(cfg, steps_per_epoch=10)
    batch = to_device(example_batch(B, args.seconds, 64), dev)
    model = init_state(task, seed=0, device=str(dev)).model.eval()
    audio_s = B * args.seconds

    def timed(fn):
        """(ms, output) of one call after a warm-up call."""
        out = {}

        def run():
            out["r"] = fn()
        ms = median_ms(run, dev, reps=1, warmup=1)
        return ms, out["r"]

    def report(label, ms, extra=None):
        print(f"{label}: {ms:.1f} ms -> {audio_s / (ms / 1e3):.0f} "
              f"audio-s/s" + (f" ({extra})" if extra else ""), flush=True)
        print(json.dumps({"decoder": label, "ms": ms,
                          "audio_s_per_s": audio_s / (ms / 1e3),
                          "device": str(dev)}), flush=True)

    with torch.no_grad():
        feats, flens = task.preprocess(batch["wav"], batch["wav_lens"])
        f, f_lens = model.encode(feats, flens)
        predict_step, joint_step, project_f, init_fn = \
            build_rnnt_decode_helpers(model)
        # Decoders run in projected joint space (factored-joint hoist).
        f = project_f(f)
        if args.blank_bias:
            base_joint = joint_step

            def joint_step(f_t, g):  # noqa: F811
                out = base_joint(f_t, g)
                return torch.cat([out[:, :1] + args.blank_bias, out[:, 1:]],
                                 dim=1)

        ms, _ = timed(lambda: rnnt_greedy_decode(
            f, f_lens, predict_step, joint_step, init_fn(B, dev),
            blank_index=0, max_symbols_per_step=8, max_output_len=128))
        report(f"rnnt greedy B={B}", ms)

        prunes = (True, False) if args.prune_ab else (True,)
        specs = ((args.spec_frames, None) if args.spec_ab
                 else (args.spec_frames,))
        for prune in prunes:
            for spec in specs:
                if spec is not None and not prune:
                    continue  # speculation requires the pruning
                ms, (toks, lens) = timed(lambda: rnnt_beam_decode(
                    f, f_lens, predict_step, joint_step,
                    init_fn(B * args.beam, dev), blank_index=0,
                    beam_width=args.beam, max_symbols_per_step=4,
                    max_output_len=128, expand_topk=args.expand_topk,
                    prune_expands=prune, speculative_frames=spec))
                report(f"rnnt beam W={args.beam} k={args.expand_topk} B={B} "
                       f"prune={prune} spec={spec}", ms,
                       f"{int(lens.sum())} tokens")

        # CTC beam on random logits of the encoder output's shape.
        rng = np.random.default_rng(0)
        T = int(f.shape[1])
        logits = torch.as_tensor(
            rng.standard_normal((B, T, 29)).astype(np.float32)).to(dev)
        ms, _ = timed(lambda: ctc_beam_decode(
            logits, f_lens, blank_index=0, beam_width=16,
            expand_topk=args.expand_topk))
        report(f"ctc beam W=16 k={args.expand_topk} B={B}", ms)

        # Word-LM scoring cost: the same beam with a bigram word LM of
        # realistic size (4096-slot tables) scored at word boundaries.
        S_tab = 4096
        wrng = np.random.default_rng(1)
        wlm = WordLMTensors.from_word_lm(WordLM(
            key1=wrng.integers(1, 2**32, S_tab, dtype=np.uint32),
            key2=wrng.integers(1, 2**32, S_tab, dtype=np.uint32),
            logp=wrng.standard_normal(S_tab).astype(np.float32),
            oov_log_prob=-10.0,
            bkey1=wrng.integers(1, 2**32, S_tab, dtype=np.uint32),
            bkey2=wrng.integers(1, 2**32, S_tab, dtype=np.uint32),
            blogp=wrng.standard_normal(S_tab).astype(np.float32),
            backoff_log=float(np.log(0.4)))).to(dev)
        ms, _ = timed(lambda: ctc_beam_decode(
            logits, f_lens, blank_index=0, beam_width=16,
            expand_topk=args.expand_topk, separator_index=1,
            word_lm_alpha=0.3, word_lm=wlm, word_count_beta=0.5))
        report(f"ctc beam W=16 + word-BIGRAM-LM B={B}", ms)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
