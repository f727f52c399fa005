"""Train-step profiler of the port: sweep the batch size and the kernels.

The port's counterpart of ``tools/profile_step.py``.  For each ``--batch``
it builds the config's train step (``rnn_t_en`` by default) on seeded noise
of ``--seconds`` with 64 labels, takes one warm-up step, then times
``--steps`` steps back to back by CUDA events (no host sync between them)
and traces the same number once more with ``torch.profiler`` for the
device's busy time and idle share.  ``--plain-lstm`` and ``--plain-lattice``
run the plain PyTorch versions of K1/K2 and of K3/K4 (the JAX tool's
``--no-pallas-lstm`` and ``--no-pallas-rnnt``): an explicit A/B.
``--fused-chunk`` sets the loss's T-chunked joint.

Usage: python port_tools/profile_step.py [--batch 8,16,32] [--plain-lstm]
       [--plain-lattice] [--seconds 5] [--steps 10] [--device cpu]

The last line of each batch size reads ``... : <ms> ms/step -> <rate>
audio-s/s`` (``port_tools/roofline.py --measure`` reads it).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = 64  # labels an utterance, as the JAX tool's


def step_figures(cfg, B: int, seconds: float, steps: int, dev,
                 plain=()) -> dict:
    """Build ``cfg``'s train task at batch ``B``, take a warm-up step, and
    return the ms a step of ``steps`` steps (CUDA events on the card), the
    traced run's busy ms and idle share, and the kernel launches a step."""
    from myrtlespeech_tpu_torch.builders.build import build_task, vocab_size
    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.run.train import (example_batch,
                                                  init_state,
                                                  kernel_launches,
                                                  make_train_step, to_device)
    from myrtlespeech_tpu_torch.utils.trace import busy_ms

    from port_tools.tool_common import median_ms, plain_versions, traced

    cfg = S.replace(cfg, train_config=S.replace(cfg.train_config,
                                                batch_size=B))
    task = build_task(cfg, steps_per_epoch=100)
    V = vocab_size(cfg.speech_to_text)
    batch = example_batch(B, seconds, LABELS)
    batch["labels"] = batch["labels"].clip(1, V - 2)
    batch = to_device(batch, dev)
    state = init_state(task, seed=0, device=str(dev))
    step = make_train_step(task)

    def run_n():
        for _ in range(steps):
            step(state, batch)

    with plain_versions(*plain):
        step(state, batch)  # warm-up: kernel builds, allocator
        ms = median_ms(run_n, dev, reps=1, warmup=0) / steps
    before = kernel_launches()  # the plain versions count no launch
    with plain_versions(*plain):
        wall_ms, logdir = traced(run_n, dev)
    after = kernel_launches()
    busy = busy_ms(logdir)
    shutil.rmtree(logdir, ignore_errors=True)
    return {"ms_per_step": ms,
            "audio_s_per_s": B * seconds / (ms / 1e3),
            "traced_ms_per_step": wall_ms / steps,
            "busy_ms_per_step": None if busy is None else busy / steps,
            "idle_share": None if busy is None else 1 - busy / wall_ms,
            "launches_per_step": {k: (after[k] - before[k]) / steps
                                  for k in after}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", default="8")
    p.add_argument("--plain-lstm", action="store_true",
                   help="K1/K2's plain PyTorch versions in place of them")
    p.add_argument("--plain-lattice", action="store_true",
                   help="K3/K4's plain PyTorch versions in place of them")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--fused-chunk", type=int, default=None,
                   help="enable joint+loss fusion with this T-chunk size")
    p.add_argument("--config", default="rnn_t_en",
                   help="config of myrtlespeech_tpu_torch/configs (e.g. "
                        "deep_speech_2_en)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.run.infer import load_config

    from port_tools.tool_common import device_of, print_card

    dev = device_of(args.device)
    print_card(dev)
    cfg = load_config(args.config.removesuffix(".py").split(".")[-1])
    if isinstance(cfg.speech_to_text.loss, S.RNNTLossConfig):
        cfg = S.replace(cfg, speech_to_text=S.replace(
            cfg.speech_to_text, loss=S.replace(
                cfg.speech_to_text.loss,
                fused_chunk_size=args.fused_chunk)))
    plain = (("lstm",) if args.plain_lstm else ()) + \
        (("rnnt",) if args.plain_lattice else ())
    for B in [int(x) for x in args.batch.split(",")]:
        r = step_figures(cfg, B, args.seconds, args.steps, dev, plain)
        print(json.dumps({"config": args.config, "batch": B,
                          "seconds": args.seconds, "steps": args.steps,
                          "plain": list(plain),
                          "fused_chunk": args.fused_chunk, **r}), flush=True)
        print(f"B={B} plain_lstm={args.plain_lstm} "
              f"plain_lattice={args.plain_lattice} "
              f"fused_chunk={args.fused_chunk} device={dev}: "
              f"{r['ms_per_step']:.1f} ms/step -> "
              f"{r['audio_s_per_s']:.0f} audio-s/s", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
