"""Beam-search WER of the trained medium RNN-T, by the JAX package and by the
port.

Loads ``benchmarks/data/rnnt_medium/trained_params_bf16.npz`` into both
packages and decodes the 256-utterance eval split of
``configs/synthetic_medium_rnnt.py`` by the config's own beam (W=8,
``length_norm``, ``max_symbols_per_step=8``, ``expand_topk`` 16,
``speculative_frames`` 8), in batches of 32 consecutive utterances
zero-padded to the longest utterance of the split, as
``port_tools/medium_greedy_wer.py`` batches them.  Both run on the CPU; the
port uses its kernels' plain versions there.  Prints one JSON line with both
WERs, the number of utterances whose transcripts differ, the port's loop
counts and its tallies (rounds a frame, the share of frames consumed as pure
blank).  ``chip_smoke.py`` holds the port's beam WER on the card to the JAX
figure.  ``--compute_dtype float32`` runs both models in float32 in place
of the config's bfloat16 (a check that transcripts which differ in bfloat16
differ through rounding, not through the decoder).

    python port_tools/medium_beam_wer.py [--compute_dtype float32]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from port_tools.medium_greedy_wer import NPZ, eval_batches  # noqa: E402


def _with_dtype(S, cfg, dtype):
    if dtype is None:
        return cfg
    return S.replace(cfg, train_config=S.replace(cfg.train_config,
                                                 compute_dtype=dtype))


def jax_transcripts(batches, dtype=None):
    import jax
    import numpy as np

    from configs.synthetic_medium_rnnt import task_config
    from myrtlespeech_tpu.builders.build import build_task
    from myrtlespeech_tpu.config import schema as S
    from myrtlespeech_tpu.models.rnn_t import RNNT
    from myrtlespeech_tpu.run.checkpoint import load_params_npz
    from myrtlespeech_tpu.run.train import init_state

    task = build_task(_with_dtype(S, task_config, dtype), steps_per_epoch=1)
    wav, lens, _ = batches[0]
    B = wav.shape[0]
    state = init_state(task, jax.random.PRNGKey(0), {
        "wav": wav, "wav_lens": lens, "labels": np.zeros((B, 4), np.int32),
        "label_lens": np.ones((B,), np.int32)})
    variables = {"params": load_params_npz(NPZ, state.params)}

    @jax.jit
    def decode(wav, lens):
        feats, flens = task.preprocess(jax.random.PRNGKey(0), wav, lens,
                                       False)
        f, f_lens = task.model.apply(variables, feats, flens,
                                     method=RNNT.encode)
        return task.decoder(variables, f, f_lens)

    texts = []
    for wav, lens, _ in batches:
        toks, tlens = (np.asarray(a) for a in decode(wav, lens))
        texts += [task.alphabet.get_symbols(toks[i, :tlens[i]])
                  for i in range(len(tlens))]
    return texts


def port_transcripts(batches, dtype=None):
    import torch

    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.configs.synthetic_medium_rnnt import \
        task_config
    from myrtlespeech_tpu_torch.decoding import rnnt_beam
    from myrtlespeech_tpu_torch.run.infer import build_transcriber
    from myrtlespeech_tpu_torch.weights import params_from_npz

    cfg = _with_dtype(S, task_config, dtype)
    tr = build_transcriber(cfg, params_from_npz(NPZ, cfg), device="cpu")
    rnnt_beam.LOOP_COUNTS.clear()
    texts, sums = [], {}
    for wav, lens, _ in batches:
        tally = {}
        with torch.inference_mode():
            wav = torch.as_tensor(wav)
            feats, flens = tr.preprocess(wav, torch.as_tensor(lens))
            f, f_lens = tr.outputs(feats, flens)
            toks, tlens = tr.decode(f, f_lens, tally=tally)
        texts += [tr.alphabet.get_symbols(toks[i, :tlens[i]].numpy())
                  for i in range(len(tlens))]
        for k, v in tally.items():
            sums[k] = sums.get(k, 0) + int(v)
    return texts, dict(rnnt_beam.LOOP_COUNTS), sums


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--compute_dtype", default=None,
                   help="both models' compute dtype (default: the "
                        "config's, bfloat16)")
    args = p.parse_args(argv)
    from myrtlespeech_tpu_torch.configs.synthetic_medium_rnnt import \
        task_config
    from myrtlespeech_tpu_torch.decoding.wer import wer

    pc = task_config.speech_to_text.post_process
    batches = eval_batches(args.n, args.batch)
    refs = [t for _, _, texts in batches for t in texts]
    t0 = time.perf_counter()
    hyp_jax = jax_transcripts(batches, args.compute_dtype)
    t1 = time.perf_counter()
    hyp_port, counts, tally = port_transcripts(batches, args.compute_dtype)
    t2 = time.perf_counter()
    print(json.dumps({
        "utterances": len(refs), "batch": args.batch,
        "beam_width": pc.beam_width, "length_norm": pc.length_norm,
        "max_symbols_per_step": pc.max_symbols_per_step,
        "expand_topk": pc.expand_topk,
        "speculative_frames": pc.speculative_frames,
        "compute_dtype": (args.compute_dtype
                          or task_config.train_config.compute_dtype),
        "jax_cpu_wer": wer(refs, hyp_jax),
        "port_cpu_wer": wer(refs, hyp_port),
        "transcripts_differing": sum(a != b for a, b in
                                     zip(hyp_jax, hyp_port)),
        "jax_cpu_s": t1 - t0, "port_cpu_s": t2 - t1,
        "port_loop_counts": counts, "port_tally": tally,
        "rounds_per_frame": (tally["pure_blank_frames"]
                             + tally["row_rounds"]) / tally["valid_frames"],
        "pure_blank_share": tally["pure_blank_frames"]
        / tally["valid_frames"]}))


if __name__ == "__main__":
    main()
