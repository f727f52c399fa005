"""Greedy WER of the trained medium RNN-T, by the JAX package and by the port.

Loads ``benchmarks/data/rnnt_medium/trained_params_bf16.npz`` into both
packages and decodes the 256-utterance eval split of
``configs/synthetic_medium_rnnt.py`` greedily with ``max_symbols_per_step=8``
(as ``tools/accuracy_ab.py`` scores greedy), in batches of 32 consecutive
utterances zero-padded to the longest utterance of the split.  Both run on
the CPU; the port uses its kernels' plain versions there.  Prints one JSON
line with both WERs and the number of utterances whose transcripts differ.
``chip_smoke.py`` holds the port's WER on the card to the JAX figure.

    python port_tools/medium_greedy_wer.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "benchmarks", "data", "rnnt_medium",
                   "trained_params_bf16.npz")


def eval_batches(n: int, batch: int):
    """``[(wav (B, S), lens (B,), texts)]`` of the medium eval split, every
    batch padded to the longest of the ``n`` utterances."""
    from myrtlespeech_tpu_torch.configs.synthetic_medium_rnnt import \
        task_config
    from myrtlespeech_tpu_torch.data.dataset.synthetic import SyntheticSpeech
    from myrtlespeech_tpu_torch.run.infer import pad_waveforms

    ds = SyntheticSpeech(task_config.eval_dataset)
    items = [ds[i] for i in range(n)]
    s_max = max(len(w) for w, _ in items)
    out = []
    for i in range(0, n, batch):
        chunk = items[i:i + batch]
        wav, lens = pad_waveforms([w for w, _ in chunk])
        wav = np.pad(wav, ((0, 0), (0, s_max - wav.shape[1])))
        out.append((wav, lens, [t for _, t in chunk]))
    return out


def jax_transcripts(batches, max_symbols: int):
    import jax

    from configs.synthetic_medium_rnnt import task_config
    from myrtlespeech_tpu.builders.build import build_task
    from myrtlespeech_tpu.config import schema as S
    from myrtlespeech_tpu.models.rnn_t import RNNT
    from myrtlespeech_tpu.run.checkpoint import load_params_npz
    from myrtlespeech_tpu.run.train import init_state

    stt = task_config.speech_to_text
    cfg = S.replace(task_config, speech_to_text=S.replace(
        stt, post_process=S.RNNTGreedyDecoderConfig(
            blank_index=stt.loss.blank_index,
            max_symbols_per_step=max_symbols)))
    task = build_task(cfg, steps_per_epoch=1)
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


def port_transcripts(batches, max_symbols: int):
    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.configs.synthetic_medium_rnnt import \
        task_config
    from myrtlespeech_tpu_torch.run.infer import build_transcriber
    from myrtlespeech_tpu_torch.weights import params_from_npz

    stt = task_config.speech_to_text
    cfg = S.replace(task_config, speech_to_text=S.replace(
        stt, post_process=S.RNNTGreedyDecoderConfig(
            blank_index=stt.loss.blank_index,
            max_symbols_per_step=max_symbols)))
    tr = build_transcriber(cfg, params_from_npz(NPZ, cfg), device="cpu")
    texts = []
    for wav, lens, _ in batches:
        texts += tr.transcribe(wav, lens).texts
    return texts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--max_symbols_per_step", type=int, default=8)
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    from myrtlespeech_tpu_torch.decoding.wer import wer

    batches = eval_batches(args.n, args.batch)
    refs = [t for _, _, texts in batches for t in texts]
    hyp_jax = jax_transcripts(batches, args.max_symbols_per_step)
    hyp_port = port_transcripts(batches, args.max_symbols_per_step)
    print(json.dumps({
        "utterances": len(refs), "batch": args.batch,
        "max_symbols_per_step": args.max_symbols_per_step,
        "jax_cpu_wer": wer(refs, hyp_jax),
        "port_cpu_wer": wer(refs, hyp_port),
        "transcripts_differing": sum(a != b for a, b in
                                     zip(hyp_jax, hyp_port))}))


if __name__ == "__main__":
    main()
