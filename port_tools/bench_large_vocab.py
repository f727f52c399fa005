"""Large-vocabulary stress of the port: losses, joint fronts, decode, word LM.

The port's counterpart of ``tools/bench_large_vocab.py``, at a wordpiece
vocabulary (V=1024 by default) where the char-level figures say little:

  losses : RNN-T (B=8) and CTC (B=32) value+grad at V through the lattice
           kernels and through their plain versions (``bench_lattice``)
  joint  : the full, chunked and joint-tail fronts at V (``bench_joint``,
           B=32), in a subprocess
  decode : RNN-T greedy and beam W=8 (expand_topk 16 and 64) on a random
           256-wide model with a V-symbol alphabet, audio-s/s
  wordlm : a >=10k-word bigram word LM: table load, probe depths, every
           stored word reachable (host only)

Usage:
  python port_tools/bench_large_vocab.py [--v 1024]
      [--parts losses,joint,decode,wordlm] [--out DIR] [--device cpu]

It prints one JSON line per measurement; with ``--out`` it also appends
each part's lines to ``DIR/<part>_v.txt``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _emit(out, record: dict) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")


def part_losses(v: int, out, dev):
    from port_tools.bench_lattice import bench_one

    for op in ("rnnt", "ctc"):
        # The full RNN-T logits (B, T, U+1, V) at V=1024 are 2 GB in fp32
        # with their gradient: keep the flagship T and U and cut B.
        B = 8 if op == "rnnt" else 32
        for impl in ("kernel", "plain"):
            rec = {"part": "losses", "op": op, "impl": impl, "B": B, "V": v,
                   "device": str(dev)}
            try:
                rec["ms"] = bench_one(op, impl, B=B, V=v, dev=dev) * 1e3
            except RuntimeError as e:  # out of memory: report, go on
                rec["error"] = f"{type(e).__name__}: {e}"
            _emit(out, rec)


def part_joint(v: int, out, dev):
    """bench_joint's three fronts at V, in a subprocess so that its lines
    land in the output as they are."""
    cmd = [sys.executable, os.path.join(REPO, "port_tools", "bench_joint.py"),
           "--V", str(v), "--B", "32", "--device", str(dev)]
    p = subprocess.run(cmd, text=True, capture_output=True, timeout=3000)
    print(p.stdout, flush=True)
    if out is not None:
        out.write(f"$ {' '.join(cmd[1:])}\n{p.stdout}")
    if p.returncode != 0:
        print(p.stderr[-2000:], file=sys.stderr)
        if out is not None:
            out.write(f"STDERR:\n{p.stderr[-2000:]}\n")


def large_vocab_config(v: int):
    """A random 256-wide RNN-T with a ``v``-symbol alphabet (blank and
    ``v - 1`` CJK characters), as the JAX tool's."""
    from myrtlespeech_tpu_torch.config import schema as S

    alphabet = "_" + "".join(chr(0x4E00 + i) for i in range(v - 1))
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet=alphabet,
            pre_process_steps=(
                S.PreProcessStepConfig(S.MFCCConfig(n_mels=64,
                                                    log_mel_only=True)),
                S.PreProcessStepConfig(S.StandardizeConfig()),
            ),
            model=S.RNNTConfig(
                encoder=S.RNNTEncoderConfig(
                    rnn1=S.RNNConfig(hidden_size=256, num_layers=2),
                    time_reduction_factor=2,
                    rnn2=S.RNNConfig(hidden_size=256, num_layers=2)),
                prediction=S.RNNTPredictNetConfig(
                    embedding_dim=128,
                    rnn=S.RNNConfig(hidden_size=128, num_layers=1)),
                joint=S.RNNTJointNetConfig(
                    fc=S.FullyConnectedConfig(num_hidden_layers=1,
                                              hidden_size=256,
                                              activation=S.Activation.RELU)),
            ),
            loss=S.RNNTLossConfig(blank_index=0, fused_chunk_size=32),
            post_process=S.RNNTGreedyDecoderConfig(blank_index=0),
        ),
        train_config=S.TrainConfig(batch_size=32),
        train_dataset=S.FakeSpeechToTextConfig(
            dataset_len=32, audio_ms=S.IntRange(4500, 5000),
            label_symbols=alphabet[1:41], label_len=S.IntRange(30, 60)),
    )


def part_decode(v: int, out, dev, B: int = 32, sec: float = 5.0,
                n_dec: int = 5, reps: int = 5):
    """Greedy and beam decode on a random model with a V-symbol alphabet:
    audio-s/s of ``n_dec`` back-to-back decodes (CUDA events, median of
    ``reps``)."""
    import numpy as np
    import torch

    from myrtlespeech_tpu_torch.builders.build import (
        build_rnnt_decode_helpers, build_task)
    from myrtlespeech_tpu_torch.decoding.rnnt_beam import rnnt_beam_decode
    from myrtlespeech_tpu_torch.decoding.rnnt_greedy import \
        rnnt_greedy_decode
    from myrtlespeech_tpu_torch.run.train import init_state

    from port_tools.tool_common import median_ms

    task = build_task(large_vocab_config(v), steps_per_epoch=10)
    rng = np.random.default_rng(0)
    wav = torch.as_tensor(rng.standard_normal(
        (B, int(16000 * sec))).astype(np.float32)).to(dev)
    wav_lens = torch.full((B,), int(16000 * sec), dtype=torch.int32,
                          device=dev)
    model = init_state(task, seed=0, device=str(dev)).model.eval()
    with torch.no_grad():
        feats, flens = task.preprocess(wav, wav_lens)
        f, f_lens = model.encode(feats, flens)
        predict_step, joint_step, project_f, init_fn = \
            build_rnnt_decode_helpers(model)
        f = project_f(f)

        def greedy():
            return rnnt_greedy_decode(
                f, f_lens, predict_step, joint_step, init_fn(B, dev),
                blank_index=0, max_symbols_per_step=8, max_output_len=128)

        def beam(k):
            return lambda: rnnt_beam_decode(
                f, f_lens, predict_step, joint_step, init_fn(B * 8, dev),
                blank_index=0, beam_width=8, max_symbols_per_step=4,
                max_output_len=128, expand_topk=k)

        for name, fn in (("greedy", greedy), ("beam8_topk16", beam(16)),
                         ("beam8_topk64", beam(64))):
            def run(fn=fn):
                for _ in range(n_dec):
                    fn()
            ms = median_ms(run, dev, reps=reps)
            _emit(out, {"part": "decode", "decoder": name, "V": v, "B": B,
                        "audio_s_per_s": n_dec * B * sec / (ms / 1e3),
                        "device": str(dev)})


def part_wordlm(n_words: int, out):
    """Build statistics and reachability of a >=10k-word bigram table."""
    import numpy as np

    from myrtlespeech_tpu_torch.data.alphabet import Alphabet
    from myrtlespeech_tpu_torch.decoding.lm import (WORD_LM_PROBES,
                                                    estimate_word_lm,
                                                    word_hashes)

    alphabet = Alphabet("_ abcdefghijklmnopqrstuvwxyz'")
    rng = np.random.default_rng(0)
    letters = "abcdefghijklmnopqrstuvwxyz"
    vocab = set()
    while len(vocab) < n_words:
        L = int(rng.integers(3, 11))
        vocab.add("".join(rng.choice(list(letters), L)))
    vocab = sorted(vocab)
    # Zipf-ish draws plus one guaranteed appearance per word, so that the
    # table stores the whole vocabulary.
    probs = 1.0 / np.arange(1, len(vocab) + 1) ** 1.1
    probs /= probs.sum()
    sents = []
    for _ in range(4000):
        n = int(rng.integers(3, 12))
        idx = rng.choice(len(vocab), n, p=probs)
        sents.append(" ".join(vocab[i] for i in idx))
    shuf = list(vocab)
    rng.shuffle(shuf)
    for k in range(0, len(shuf), 8):
        sents.append(" ".join(shuf[k:k + 8]))
    seen = set(w for s in sents for w in s.split())
    t0 = time.perf_counter()
    lm = estimate_word_lm(sents, alphabet, order=2)
    build_s = time.perf_counter() - t0

    S_uni = lm.key1.shape[0]
    used = int(np.sum((lm.key1 != 0) | (lm.key2 != 0)))
    S_bi = lm.bkey1.shape[0] if lm.bkey1 is not None else 0
    used_bi = int(np.sum((lm.bkey1 != 0) | (lm.bkey2 != 0))) if S_bi else 0

    # How many probes each stored word needs.
    depth = np.zeros(WORD_LM_PROBES + 1, np.int64)
    misplaced = 0
    for w in sorted(seen):
        h1, h2 = word_hashes(alphabet.get_indices(w))
        if h1 == 0 and h2 == 0:
            h1 = np.uint32(1)
        step = np.uint32(h2 | 1)
        for j in range(WORD_LM_PROBES):
            with np.errstate(over="ignore"):
                idx = int((h1 + np.uint32(j) * step) & np.uint32(S_uni - 1))
            if lm.key1[idx] == h1 and lm.key2[idx] == h2:
                depth[j] += 1
                break
        else:
            misplaced += 1
    _emit(out, {
        "part": "wordlm", "n_vocab": len(vocab), "n_stored": len(seen),
        "build_s": build_s, "uni_slots": S_uni, "uni_load": used / S_uni,
        "bi_slots": S_bi, "bi_load": used_bi / max(S_bi, 1),
        "probe_hist": depth[:WORD_LM_PROBES].tolist(),
        "unreachable_words": misplaced, "probes_budget": WORD_LM_PROBES})
    if misplaced:
        raise SystemExit(f"{misplaced} stored words are unreachable within "
                         f"{WORD_LM_PROBES} probes")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--v", type=int, default=1024)
    p.add_argument("--wordlm_vocab", type=int, default=12000)
    p.add_argument("--parts", default="losses,joint,decode,wordlm")
    p.add_argument("--out", default=None,
                   help="also append each part's lines to OUT/<part>_v.txt")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from port_tools.tool_common import device_of, print_card

    dev = device_of(args.device)
    print_card(dev)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for part in args.parts.split(","):
        with contextlib.ExitStack() as stack:
            f = None
            if args.out:
                f = stack.enter_context(open(
                    os.path.join(args.out, f"{part}_v.txt"), "a"))
                f.write(f"# bench_large_vocab {part} v={args.v} "
                        f"({time.strftime('%Y-%m-%d %H:%M')})\n")
            if part == "losses":
                part_losses(args.v, f, dev)
            elif part == "joint":
                part_joint(args.v, f, dev)
            elif part == "decode":
                part_decode(args.v, f, dev)
            elif part == "wordlm":
                part_wordlm(args.wordlm_vocab, f)
            else:
                raise SystemExit(f"unknown part {part!r}")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
